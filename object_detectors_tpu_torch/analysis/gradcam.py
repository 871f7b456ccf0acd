"""Grad-CAM for the YOLO head (port of the JAX package's
``analysis/gradcam.py``; `yolo/utilities/gradcam.py:8-190` rebuilt).

The graph is split at the backbone boundary: the backbone runs once without
autograd, its C5 activation becomes a leaf that requires a gradient, and
the head alone (neck -> embedding0/1/2 with the laterals, as
``YoloHead.forward`` after the backbone) runs from (C3, C4, C5). Autograd
gives d(class score)/d(C5), and CAM = ReLU(sum_c w_c * A_c) with w_c the
spatial mean of that gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detectors_tpu_torch.models.common import upsample_nearest_2x
from object_detectors_tpu_torch.models.yolo import YoloHead


def yolo_gradcam(model: YoloHead, image, class_id: int, scale: int = 0) -> np.ndarray:
    """image [1, H, W, 3] (normalized; tensor or array) -> CAM [h, w] in
    [0, 1] at the backbone's C5 resolution, upsampling left to the caller.

    scale selects which detection scale's class logits form the target
    score (0 = stride 32). The model runs in eval mode (running batch-norm
    statistics)."""
    model = model.eval()
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(image), dtype=torch.float32, device=device)
    x = x.permute(0, 3, 1, 2).to(model.dtype).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        c3, c4, c5 = model.backbone(x, False)
    c5 = c5.detach().requires_grad_(True)
    out = _apply_head_only(model, c3, c4, c5)[scale]
    b, h, w, _ = out.shape
    logits = out.reshape(b, h, w, model.anchors_per_scale, 5 + model.num_classes)
    (grads,) = torch.autograd.grad(logits[..., 5 + class_id].sum(), c5)
    acts = c5[0].detach().permute(1, 2, 0).float().cpu().numpy()   # [h, w, C]
    g = grads[0].permute(1, 2, 0).float().cpu().numpy()
    weights = g.mean(axis=(0, 1))  # [C]
    cam = np.maximum((acts * weights[None, None, :]).sum(-1), 0.0)
    if cam.max() > 0:
        cam = cam / cam.max()
    return cam


def _apply_head_only(model: YoloHead, c3, c4, c5):
    """``YoloHead.forward`` after the backbone, in eval mode: the raw NHWC
    maps at strides (32, 16, 8)."""
    x0, x1, x2 = model.neck((c5, c4, c3))
    out0, branch0 = model.embedding0(x0, False)
    x1_in = torch.cat([upsample_nearest_2x(model.lateral1(branch0, False)), x1], 1)
    out1, branch1 = model.embedding1(x1_in, False)
    x2_in = torch.cat([upsample_nearest_2x(model.lateral2(branch1, False)), x2], 1)
    out2, _ = model.embedding2(x2_in, False)
    return tuple(o.permute(0, 2, 3, 1) for o in (out0, out1, out2))
