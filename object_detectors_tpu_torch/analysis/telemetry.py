"""Telemetry: visualization of raw head outputs, GT, and detections.

Port of the JAX package's ``analysis/telemetry.py``; parity with
`yolo/utilities/telemetry.py:12-293` (and the smaller
`torchvision_models/utilities/telemetry.py`): image de-normalization,
GT / prediction bbox drawing, per-cell heatmaps of any head attribute,
per-cell best-IoU maps against GT, and the confidence x IoU x
class-correctness "performance" map. All functions return numpy arrays;
matplotlib rendering is a thin optional layer so the module works
headless.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detectors_tpu_torch.kernels.preprocess import IMAGENET_MEAN, IMAGENET_STD
from object_detectors_tpu_torch.ops import boxes as box_ops

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """Invert ResizeToTensor's normalization -> uint8 HWC."""
    x = np.asarray(img, np.float32) * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def draw_boxes(image: np.ndarray, boxes_xyxy, labels=None, scores=None,
               color=(0, 255, 0), names=None, thickness=2) -> np.ndarray:
    """cv2 bbox + caption drawing (telemetry.draw_bbs /
    draw_pretty_bbs)."""
    out = np.ascontiguousarray(image.copy())
    if cv2 is None:
        return out
    for i, b in enumerate(np.asarray(boxes_xyxy)):
        x1, y1, x2, y2 = [int(round(float(v))) for v in b]
        cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
        caption = ""
        if labels is not None:
            lab = int(np.asarray(labels)[i])
            caption = names[lab] if names and 0 <= lab < len(names) \
                else str(lab)
        if scores is not None:
            caption += f" {float(np.asarray(scores)[i]):.2f}"
        if caption:
            cv2.putText(out, caption, (x1, max(y1 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
    return out


def _scale_grid(decoded, attr, grid_hw, anchors_per_scale=3, reduce="max"):
    """Slice one scale out of the flat [P, ...] prior axis and reduce the
    anchor dim -> [H, W] heatmap."""
    h, w = grid_hw
    n = h * w * anchors_per_scale
    block = np.asarray(attr[:n]).reshape(h, w, anchors_per_scale)
    return block.max(-1) if reduce == "max" else block.mean(-1)


def attribute_heatmap(decoded: np.ndarray, attr_index: int,
                      grid_sizes, anchors_per_scale=3):
    """Per-scale [H, W] heatmaps of one decoded attribute
    (vis_attrib): e.g. attr_index=4 for objectness confidence."""
    return _per_scale(np.asarray(decoded)[:, attr_index], grid_sizes, anchors_per_scale)


def class_heatmap(decoded, class_id, grid_sizes, anchors_per_scale=3):
    """vis_class: probability heatmap of one class per scale."""
    return attribute_heatmap(decoded, 5 + class_id, grid_sizes,
                             anchors_per_scale)


def _best_iou(decoded, gt_boxes_cxcywh):
    """Per prior: the best IoU against the GT and that GT's index."""
    pred = torch.from_numpy(np.asarray(decoded[:, :4], np.float32))
    gt = torch.from_numpy(np.asarray(gt_boxes_cxcywh, np.float32))
    iou = box_ops.box_iou(pred[:, None, :], gt[None, :, :])
    best, arg = iou.max(1)
    return best.numpy(), arg.numpy()


def _per_scale(values, grid_sizes, anchors_per_scale):
    maps = []
    start = 0
    for gs in grid_sizes:
        n = gs * gs * anchors_per_scale
        maps.append(_scale_grid(None, values[start:start + n], (gs, gs), anchors_per_scale))
        start += n
    return maps


def iou_heatmap(decoded, gt_boxes_cxcywh, grid_sizes, anchors_per_scale=3):
    """vis_iou: per-prior best IoU against GT, per scale [H, W]."""
    return _per_scale(_best_iou(decoded, gt_boxes_cxcywh)[0], grid_sizes, anchors_per_scale)


def performance_heatmap(decoded, gt_boxes_cxcywh, gt_labels, grid_sizes,
                        anchors_per_scale=3):
    """vis_performance: conf x best-IoU x class-correctness per cell."""
    best_iou, best_gt = _best_iou(decoded, gt_boxes_cxcywh)
    conf = np.asarray(decoded[:, 4])
    pred_cls = np.asarray(decoded[:, 5:]).argmax(-1)
    correct = (pred_cls == np.asarray(gt_labels)[best_gt]).astype(np.float32)
    return _per_scale(conf * best_iou * correct, grid_sizes, anchors_per_scale)


def render_heatmap(ax, heatmap, title=""):  # pragma: no cover - viz only
    """Optional matplotlib/seaborn rendering (telemetry's seaborn
    heatmaps)."""
    try:
        import seaborn as sns

        sns.heatmap(heatmap, ax=ax, cbar=True)
    except ImportError:
        ax.imshow(heatmap)
    ax.set_title(title)
