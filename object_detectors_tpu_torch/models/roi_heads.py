"""RoI box head and detection postprocess for inference (port of the JAX
package's ``models/roi_heads.py``, torchvision RoIHeads semantics).

``TwoMLPHead`` flattens the pooled [B, N, oh, ow, C] features in (y, x, c)
order, the JAX layout, so its ``fc6`` takes the Flax kernel as a plain
transpose. ``postprocess_detections`` covers the ``ce`` classifier: softmax
of the (tf-idf scaled) logits, background dropped, score threshold, exact
top-``pre_nms_candidates`` (proposal, class) pairs, decode, clip, small-box
mask, class-aware NMS, ``detections_per_img`` kept. The other loss types and
the training functions come with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.models.common import linear
from object_detectors_tpu_torch.ops.boxes import (
    clip_boxes_to_image, decode_boxes, small_box_mask,
)
from object_detectors_tpu_torch.ops.nms import batched_nms, gather_rows
from object_detectors_tpu_torch.ops.selection import radix_topk


@dataclasses.dataclass(frozen=True)
class RoIHeadsConfig:
    """The inference settings of the JAX ``RoIHeadsConfig``."""

    num_classes: int = 91          # including background at index 0
    box_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    pre_nms_candidates: int = 1000
    loss_type: str = "ce"
    pool_size: tuple = (7, 7)


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, representation_size: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_features, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, oh, ow, C] -> [B, N, representation_size]."""
        x = F.relu(linear(x.flatten(2), self.fc6))
        return F.relu(linear(x, self.fc7))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return linear(x, self.cls_score), linear(x, self.bbox_pred)


def postprocess_detections(class_logits: torch.Tensor, box_regression: torch.Tensor,
                           proposals: torch.Tensor, prop_valid: torch.Tensor, image_size,
                           cfg: RoIHeadsConfig, tfidf_post: torch.Tensor | float = 1.0):
    """class_logits [B, P, C], box_regression [B, P, 4C], proposals [B, P, 4],
    prop_valid [B, P] -> (boxes [B, D, 4], scores [B, D], labels [B, D]
    1-based, -1 where not valid; valid [B, D])."""
    if cfg.loss_type != "ce":
        raise ValueError(f"loss_type {cfg.loss_type!r} is not ported; only 'ce' is")
    b, p, c = class_logits.shape
    scores = torch.softmax(class_logits * tfidf_post, -1)
    # (proposal, class) pairs without the background column; the NMS
    # candidates are selected first and only their boxes decoded
    fscores = scores[..., 1:].reshape(b, -1)
    fvalid = prop_valid[..., None].expand(b, p, c - 1).reshape(b, -1)
    fvalid = fvalid & (fscores > cfg.score_thresh)
    topv, topi = radix_topk(torch.where(fvalid, fscores, float("-inf")),
                            cfg.pre_nms_candidates)
    prop_idx = topi // (c - 1)
    cls_idx = topi % (c - 1) + 1
    reg = box_regression.reshape(b, p * c, 4)
    sel_reg = gather_rows(reg, prop_idx * c + cls_idx)
    sel_boxes = decode_boxes(sel_reg, gather_rows(proposals, prop_idx), cfg.box_weights)
    sel_boxes = clip_boxes_to_image(sel_boxes, image_size)
    valid = torch.isfinite(topv) & small_box_mask(sel_boxes, 1e-2)
    out_boxes, out_scores, out_labels, _, out_valid = batched_nms(
        sel_boxes, torch.where(valid, topv, 0.0), cls_idx.to(torch.int32), cfg.nms_thresh,
        cfg.detections_per_img, valid)
    return out_boxes, out_scores, out_labels, out_valid
