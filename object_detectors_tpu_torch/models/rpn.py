"""Region Proposal Network (port of the JAX package's ``models/rpn.py``,
torchvision RPN semantics).

``RPNHead`` runs the shared 3x3 conv and the 1x1 objectness (A) and delta
(4A) convs on each level and flattens them in (h, w, a) order, as
concatenate_box_prediction_layers does; the JAX package's packed canvas is a
TPU device and is not ported. ``filter_proposals`` takes the per-level
top-``pre_n`` (levels with fewer anchors are padded with -inf), applies the
sigmoid, the clip to the image, the small-box mask and the score threshold,
runs greedy NMS independently per level (``ops/nms.py:fixedpoint_keep``,
the NMS kernel on the GPU) and keeps the ``post_n`` best survivors over all
levels (``pre_nms_top_n_train`` / ``post_nms_top_n_train`` when
``training``). ``rpn_loss`` matches the anchors to the GT (0.7 / 0.3 with
the low-quality recovery; 1 foreground, 0 background, -1 ignored),
samples 256 a image at 0.5 positives and returns the smooth-L1 (beta 1/9)
box loss over the positives and the BCE over all sampled, both divided by
the number sampled in the batch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.models.common import conv2d
from object_detectors_tpu_torch.ops import losses as L
from object_detectors_tpu_torch.ops import matcher as M
from object_detectors_tpu_torch.ops.boxes import (
    clip_boxes_to_image, encode_boxes, pairwise_iou, small_box_mask,
)
from object_detectors_tpu_torch.ops.nms import fixedpoint_keep, gather_rows
from object_detectors_tpu_torch.ops.sampler import balanced_sample
from object_detectors_tpu_torch.ops.selection import radix_topk, radix_topk_multi
from object_detectors_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class RPNConfig:
    fg_iou_thresh: float = 0.7
    bg_iou_thresh: float = 0.3
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    pre_nms_top_n_train: int = 2000
    pre_nms_top_n_test: int = 1000
    post_nms_top_n_train: int = 2000
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


def level_topk(objectness: torch.Tensor, level_sizes, pre_n: int):
    """Each level's top-min(pre_n, level size) logits: ([(values, indices)
    [B, k_l]], [k_l])."""
    objs = objectness.split(level_sizes, 1)
    ks = [min(pre_n, o.shape[1]) for o in objs]
    return radix_topk_multi(objs, ks), ks


def level_candidates(proposals: torch.Tensor, objectness: torch.Tensor, level_sizes,
                     image_size, cfg: RPNConfig, training: bool = False):
    """Per-level NMS candidates: (boxes [B, L, pre_n, 4] clipped, scores
    [B, L, pre_n] after the sigmoid, -inf where a box is dropped)."""
    pre_n = cfg.pre_nms_top_n_train if training else cfg.pre_nms_top_n_test
    tops, ks = level_topk(objectness, level_sizes, pre_n)
    logits, boxes = [], []
    for (topv, topi), props, k in zip(tops, proposals.split(level_sizes, 1), ks):
        logits.append(F.pad(topv, (0, pre_n - k), value=float("-inf")))
        boxes.append(F.pad(gather_rows(props, topi), (0, 0, 0, pre_n - k)))
    logits = torch.stack(logits, 1)
    boxes = clip_boxes_to_image(torch.stack(boxes, 1), image_size)
    scores = torch.sigmoid(logits)
    keep = (small_box_mask(boxes, cfg.min_size) & (scores >= cfg.score_thresh)
            & torch.isfinite(logits))
    return boxes, torch.where(keep, scores, float("-inf"))


def filter_proposals(proposals: torch.Tensor, objectness: torch.Tensor, level_sizes,
                     image_size, cfg: RPNConfig, training: bool = False):
    """Decoded proposals [B, A_total, 4] and objectness logits [B, A_total]
    -> (boxes [B, P, 4], scores [B, P], valid [B, P]), P = post_n; invalid
    rows hold zeros. No gradient flows through."""
    proposals, objectness = proposals.detach(), objectness.detach()
    boxes, scores = level_candidates(proposals, objectness, level_sizes, image_size, cfg,
                                     training)
    return merge_survivors(boxes, level_survivors(boxes, scores, cfg),
                           cfg.post_nms_top_n_train if training else cfg.post_nms_top_n_test)


def level_survivors(boxes: torch.Tensor, scores: torch.Tensor, cfg: RPNConfig) -> torch.Tensor:
    """Greedy NMS on each level's candidates: their scores [B, L * pre_n],
    -inf where a box is suppressed or dropped."""
    b, levels, pre_n = scores.shape
    kept = fixedpoint_keep(boxes.reshape(b * levels, pre_n, 4),
                           scores.reshape(b * levels, pre_n), cfg.nms_thresh)
    return torch.where(kept.reshape(b, -1), scores.reshape(b, -1), float("-inf"))


def merge_survivors(boxes: torch.Tensor, flat: torch.Tensor, post_n: int):
    """The ``post_n`` best survivors over all levels: (boxes [B, post_n, 4],
    scores, valid); invalid rows hold zeros."""
    topv, topi = radix_topk(flat, post_n)
    valid = torch.isfinite(topv)
    out_boxes = torch.where(valid[..., None],
                            gather_rows(boxes.reshape(boxes.shape[0], -1, 4), topi), 0.0)
    return out_boxes, torch.where(valid, topv, 0.0), valid


def _assign_per_image(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor,
                      cfg: RPNConfig):
    """The anchors' targets, every image at once: gt_boxes [B, M, 4] xyxy,
    gt_valid [B, M], anchors [A, 4] -> (labels [B, A] f32: 1 foreground, 0
    background, -1 ignored; matched GT boxes [B, A, 4]). An image without a
    valid GT is all background, matched to zeros."""
    quality = pairwise_iou(gt_boxes, anchors)  # [B, M, A]
    matched = M.match(quality, gt_valid, cfg.fg_iou_thresh, cfg.bg_iou_thresh,
                      allow_low_quality_matches=True)
    labels = torch.where(matched >= 0, 1.0, 0.0)
    labels = torch.where(matched == M.BETWEEN_THRESHOLDS, -1.0, labels)
    no_gt = ~gt_valid.any(-1, keepdim=True)  # [B, 1]
    labels = torch.where(no_gt, 0.0, labels)
    midx = matched.clamp(min=0)
    matched_boxes = gather_rows(gt_boxes, midx)
    matched_boxes = torch.where(no_gt[..., None], 0.0, matched_boxes)
    return labels, matched_boxes


def rpn_loss(objectness: torch.Tensor, pred_deltas: torch.Tensor, anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor, cfg: RPNConfig, uniforms=None,
             generator: torch.Generator | None = None) -> dict:
    """objectness [B, A] f32, deltas [B, A, 4], anchors [A, 4], GT boxes
    [B, M, 4] xyxy with validity [B, M] -> dict(loss_objectness,
    loss_rpn_box_reg). The sampler's uniforms ``(u_pos, u_neg)`` [B, A] are
    given or drawn from ``generator``."""
    labels, matched_boxes = _assign_per_image(gt_boxes, gt_valid, anchors, cfg)
    reg_targets = encode_boxes(matched_boxes, anchors[None], cfg.box_weights)
    # Background images match zero boxes: their targets are inf or NaN and
    # never positive, but inf * 0 is NaN in a masked sum, so zero them.
    reg_targets = torch.where((labels >= 1.0)[..., None], torch.nan_to_num(reg_targets), 0.0)
    pos_mask, neg_mask = balanced_sample(labels.int(), cfg.batch_size_per_image,
                                         cfg.positive_fraction, uniforms, generator)
    sampled = pos_mask | neg_mask
    # the global batch's count; each rank returns its share (parallel/mesh.py)
    num_sampled = mesh.global_sum(sampled.sum()).clamp(min=1).to(objectness.dtype)
    box_l = L.smooth_l1_loss(pred_deltas, reg_targets, beta=1.0 / 9).sum(-1)
    loss_box = (box_l * pos_mask).sum() / num_sampled
    obj_l = L.sigmoid_binary_cross_entropy(objectness, labels)
    loss_obj = (obj_l * sampled).sum() / num_sampled
    return {"loss_objectness": mesh.rank_share(loss_obj),
            "loss_rpn_box_reg": mesh.rank_share(loss_box)}
