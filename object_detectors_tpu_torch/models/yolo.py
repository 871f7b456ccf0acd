"""YOLOv3 detector graph (port of the JAX package's ``models/yolo.py``):
Darknet backbone -> optional SPP/FPN neck -> three detection branches.

The public boundary keeps the JAX layout: images in as NHWC
``[B, H, W, 3]``, raw maps out as NHWC ``[B, H_s, W_s, A*(5+C)]`` for
strides (32, 16, 8), whose flattened (h, w, a) order is what
``flatten_raw_outputs`` and the priors expect. Inside, tensors are NCHW in
``channels_last`` memory, so both permutes are views. Submodule names follow
the Flax module names.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.models.common import (
    ConvBN, conv2d, max_pool_same, upsample_nearest_2x,
)
from object_detectors_tpu_torch.models.darknet import DarkNet
from object_detectors_tpu_torch.models.fpn import FeaturePyramidNetwork


class SPP(nn.Module):
    """Spatial pyramid pooling on each scale: the concat of the map and its
    max pools (``pyramids[k]`` windows, stride 1, same padding), then a 1x1
    conv with bias (``bottleneck{k}``) back to the map's width. With
    ``bottleneck=False`` only the coarsest scale (k = 0) has it, as in the
    Flax module; the finer ones pass the concat on."""

    def __init__(self, channels: Sequence[int], pyramids: Sequence[Sequence[int]],
                 bottleneck: bool = True):
        super().__init__()
        self.pyramids = tuple(tuple(p) for p in pyramids)
        self.bottleneck = bottleneck
        for k, (c, windows) in enumerate(zip(channels, self.pyramids)):
            if bottleneck or k == 0:
                self.add_module(f"bottleneck{k}", nn.Conv2d(c * (1 + len(windows)), c, 1))

    def forward(self, feats):
        # feats coarse -> fine: (x0 1024 ch, x1 512, x2 256)
        outs = []
        for k, (x, windows) in enumerate(zip(feats, self.pyramids)):
            cat = torch.cat([x] + [max_pool_same(x, w) for w in windows], 1)
            outs.append(conv2d(cat, getattr(self, f"bottleneck{k}"))
                        if self.bottleneck or k == 0 else cat)
        return tuple(outs)


class YoloNeck(nn.Module):
    """Optional SPP and/or FPN fusion of (C5, C4, C3). The FPN path is the
    JAX package's single pass: one ``FeaturePyramidNetwork`` (256 wide, no
    extra block) over (C3, C4, C5); its finest output replaces C3, and its
    second is concatenated to C4 and projected back to 512 by ``fpn_proj1``
    (1x1 conv with bias). C5 passes unchanged."""

    def __init__(self, use_spp: bool = False, use_fpn: bool = False,
                 pyramids: Sequence[Sequence[int]] = ((5, 9, 13),) * 3):
        super().__init__()
        self.use_spp, self.use_fpn = use_spp, use_fpn
        c3, c4, c5 = DarkNet.out_channels
        if use_spp:
            self.spp = SPP((c5, c4, c3), pyramids)
        if use_fpn:
            self.fpn = FeaturePyramidNetwork((c3, c4, c5), 256, extra_blocks=None)
            self.fpn_proj1 = nn.Conv2d(c4 + 256, c4, 1)

    def forward(self, feats):
        x0, x1, x2 = feats  # coarse (1024) -> fine (256)
        if self.use_spp:
            x0, x1, x2 = self.spp((x0, x1, x2))
        if self.use_fpn:
            fine_outs = self.fpn([x2, x1, x0])
            x2 = fine_outs[0]
            x1 = conv2d(torch.cat([x1, fine_outs[1]], 1), self.fpn_proj1)
        return x0, x1, x2


class DetectionBranch(nn.Module):
    """Five alternating CBLs + a 3x3 CBL + the 1x1 conv_out.
    Returns (raw_out, branch feature after the fifth CBL)."""

    def __init__(self, in_features: int, mid: int, wide: int, out_features: int):
        super().__init__()
        plan = [(mid, 1), (wide, 3), (mid, 1), (wide, 3), (mid, 1)]
        prev = in_features
        for i, (f, k) in enumerate(plan):
            self.add_module(f"cbl{i}", ConvBN(prev, f, k))
            prev = f
        self.cbl5 = ConvBN(mid, wide, 3)
        self.conv_out = nn.Conv2d(wide, out_features, 1, bias=True)

    def forward(self, x: torch.Tensor, train: bool = False):
        for i in range(5):
            x = getattr(self, f"cbl{i}")(x, train)
        branch = x
        x = self.cbl5(x, train)
        w = self.conv_out
        out = F.conv2d(x, w.weight.to(x.dtype), w.bias.to(x.dtype))
        return out, branch


class YoloHead(nn.Module):
    """Full YOLOv3 graph; output channels per scale = A * (5 + num_classes).
    ``dtype`` is the activation dtype; parameters stay float32."""

    def __init__(self, num_classes: int = 80, anchors_per_scale: int = 3,
                 backbone_layers: Sequence[int] = (1, 2, 8, 8, 4),
                 dtype: torch.dtype = torch.float32, use_spp: bool = False,
                 use_fpn: bool = False,
                 pyramids: Sequence[Sequence[int]] = ((5, 9, 13),) * 3):
        super().__init__()
        self.num_classes = num_classes
        self.anchors_per_scale = anchors_per_scale
        self.dtype = dtype
        out_f = anchors_per_scale * (5 + num_classes)
        self.backbone = DarkNet(backbone_layers)
        self.neck = YoloNeck(use_spp, use_fpn, pyramids)
        self.embedding0 = DetectionBranch(1024, 512, 1024, out_f)
        self.lateral1 = ConvBN(512, 256, 1)
        self.embedding1 = DetectionBranch(256 + 512, 256, 512, out_f)
        self.lateral2 = ConvBN(256, 128, 1)
        self.embedding2 = DetectionBranch(128 + 256, 128, 256, out_f)

    def forward(self, images: torch.Tensor, train: bool = False):
        """``train``: batch norm with the batch statistics, updating the
        running ones (``ConvBN``), as the Flax module's ``train=True``."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        c3, c4, c5 = self.backbone(x, train)
        x0, x1, x2 = self.neck((c5, c4, c3))
        out0, branch0 = self.embedding0(x0, train)
        # concat order [upsample(lateral), skip], as in the Flax graph
        x1_in = torch.cat([upsample_nearest_2x(self.lateral1(branch0, train)), x1], 1)
        out1, branch1 = self.embedding1(x1_in, train)
        x2_in = torch.cat([upsample_nearest_2x(self.lateral2(branch1, train)), x2], 1)
        out2, _ = self.embedding2(x2_in, train)
        # (stride 32, stride 16, stride 8) raw maps, NHWC
        return tuple(o.permute(0, 2, 3, 1) for o in (out0, out1, out2))


@torch.no_grad()
def init_yolo_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random init from a seeded ``torch.Generator`` on the CPU (so the same
    seed gives the same weights whatever device the model moves to):
    LeCun-normal conv kernels, zero conv_out biases, identity batch norm."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
