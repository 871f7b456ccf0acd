"""Region Proposal Network for inference (port of the JAX package's
``models/rpn.py``, torchvision RPN semantics).

``RPNHead`` runs the shared 3x3 conv and the 1x1 objectness (A) and delta
(4A) convs on each level and flattens them in (h, w, a) order, as
concatenate_box_prediction_layers does; the JAX package's packed canvas is a
TPU device and is not ported. ``filter_proposals`` takes the per-level
top-``pre_n`` (levels with fewer anchors are padded with -inf), applies the
sigmoid, the clip to the image, the small-box mask and the score threshold,
runs greedy NMS independently per level (``ops/nms.py:fixedpoint_keep``,
the NMS kernel on the GPU) and keeps the ``post_n`` best survivors over all
levels.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.models.common import conv2d
from object_detectors_tpu_torch.ops.boxes import clip_boxes_to_image, small_box_mask
from object_detectors_tpu_torch.ops.nms import fixedpoint_keep, gather_rows
from object_detectors_tpu_torch.ops.selection import radix_topk, radix_topk_multi


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    """The test-time settings of the JAX ``RPNConfig`` (the training ones
    come with the training slice)."""

    pre_nms_top_n_test: int = 1000
    post_nms_top_n_test: int = 1000
    nms_thresh: float = 0.7
    score_thresh: float = 0.0
    min_size: float = 1e-3
    box_weights: tuple = (1.0, 1.0, 1.0, 1.0)


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, features):
        """NCHW level maps -> (objectness [B, A_total], deltas [B, A_total, 4],
        anchors per level)."""
        obj, reg = [], []
        for f in features:
            t = F.relu(conv2d(f, self.conv))
            obj.append(conv2d(t, self.cls_logits).permute(0, 2, 3, 1).reshape(f.shape[0], -1))
            reg.append(conv2d(t, self.bbox_pred).permute(0, 2, 3, 1).reshape(f.shape[0], -1, 4))
        return torch.cat(obj, 1), torch.cat(reg, 1), tuple(o.shape[1] for o in obj)


def level_candidates(proposals: torch.Tensor, objectness: torch.Tensor, level_sizes,
                     image_size, cfg: RPNConfig):
    """Per-level NMS candidates: (boxes [B, L, pre_n, 4] clipped, scores
    [B, L, pre_n] after the sigmoid, -inf where a box is dropped)."""
    pre_n = cfg.pre_nms_top_n_test
    objs = objectness.split(level_sizes, 1)
    ks = [min(pre_n, o.shape[1]) for o in objs]
    logits, boxes = [], []
    for (topv, topi), props, k in zip(radix_topk_multi(objs, ks),
                                      proposals.split(level_sizes, 1), ks):
        logits.append(F.pad(topv, (0, pre_n - k), value=float("-inf")))
        boxes.append(F.pad(gather_rows(props, topi), (0, 0, 0, pre_n - k)))
    logits = torch.stack(logits, 1)
    boxes = clip_boxes_to_image(torch.stack(boxes, 1), image_size)
    scores = torch.sigmoid(logits)
    keep = (small_box_mask(boxes, cfg.min_size) & (scores >= cfg.score_thresh)
            & torch.isfinite(logits))
    return boxes, torch.where(keep, scores, float("-inf"))


def filter_proposals(proposals: torch.Tensor, objectness: torch.Tensor, level_sizes,
                     image_size, cfg: RPNConfig):
    """Decoded proposals [B, A_total, 4] and objectness logits [B, A_total]
    -> (boxes [B, P, 4], scores [B, P], valid [B, P]), P = post_n; invalid
    rows hold zeros."""
    boxes, scores = level_candidates(proposals, objectness, level_sizes, image_size, cfg)
    b, levels, pre_n = scores.shape
    kept = fixedpoint_keep(boxes.reshape(b * levels, pre_n, 4),
                           scores.reshape(b * levels, pre_n), cfg.nms_thresh)
    flat = torch.where(kept.reshape(b, -1), scores.reshape(b, -1), float("-inf"))
    topv, topi = radix_topk(flat, cfg.post_nms_top_n_test)
    valid = torch.isfinite(topv)
    out_boxes = torch.where(valid[..., None], gather_rows(boxes.reshape(b, -1, 4), topi), 0.0)
    return out_boxes, torch.where(valid, topv, 0.0), valid
