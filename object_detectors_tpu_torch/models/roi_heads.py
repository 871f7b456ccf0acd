"""RoI box head, its training targets and loss, and the detection
postprocess (port of the JAX package's ``models/roi_heads.py``, torchvision
RoIHeads semantics).

``TwoMLPHead`` flattens the pooled [B, N, oh, ow, C] features in (y, x, c)
order, the JAX layout, so its ``fc6`` takes the Flax kernel as a plain
transpose. ``postprocess_detections`` scores the (tf-idf scaled) logits as the
classifier's ``loss_type`` was trained (softmax for ``ce``, the Gompertz
link for ``gombit`` and ``gombit_fl``, a sigmoid for ``bce`` and
``focal_loss``), drops the background, thresholds, takes the exact
top-``pre_nms_candidates`` (proposal, class) pairs, decodes, clips, masks
small boxes, runs class-aware NMS and keeps ``detections_per_img``.

Training: ``select_training_samples`` appends the GT boxes to the
proposals, matches them at 0.5 / 0.5 without the low-quality recovery
(labels: the GT class, 0 background, -1 ignored), samples 512 a image at
0.25 positives and gathers a fixed ``batch_size_per_image`` slots, sampled
first; ``fastrcnn_loss`` is the classification loss of one of five
``loss_type``s (ce, bce, focal_loss, gombit, gombit_fl) plus the smooth-L1
box loss at the GT class's deltas, both over the number sampled.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.data.idf import minibatch_idf
from object_detectors_tpu_torch.models.common import linear
from object_detectors_tpu_torch.ops import losses as L
from object_detectors_tpu_torch.ops import matcher as M
from object_detectors_tpu_torch.ops.boxes import (
    clip_boxes_to_image, decode_boxes, encode_boxes, pairwise_iou, small_box_mask,
)
from object_detectors_tpu_torch.ops.nms import batched_nms, gather_rows
from object_detectors_tpu_torch.ops.sampler import balanced_sample, sampler_uniforms
from object_detectors_tpu_torch.ops.selection import radix_topk
from object_detectors_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class RoIHeadsConfig:
    """The JAX ``RoIHeadsConfig`` less its TPU pooler switch."""

    num_classes: int = 91          # including background at index 0
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.5
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    box_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100
    pre_nms_candidates: int = 1000
    loss_type: str = "ce"          # ce | bce | focal_loss | gombit | gombit_fl
    pool_size: tuple = (7, 7)
    # training logit scale recomputed from the minibatch, log((B+1)/(df+1))+1,
    # optionally Lp-normalized (p = tfidf_norm, 0 = off)
    tfidf_mini_batch: bool = False
    tfidf_norm: int = 0


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


def select_training_samples(proposals: torch.Tensor, prop_valid: torch.Tensor,
                            gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                            gt_valid: torch.Tensor, cfg: RoIHeadsConfig, uniforms=None,
                            generator: torch.Generator | None = None):
    """Proposals [B, P, 4] with validity [B, P], GT boxes [B, M, 4], labels
    [B, M] (1-based, 0 background) and validity [B, M] -> the S =
    ``batch_size_per_image`` slots of every image: (boxes [B, S, 4], labels
    [B, S] (0 where not sampled), regression targets [B, S, 4], positive
    [B, S], sampled [B, S], matched GT index [B, S]). The sampler's uniforms
    ``(u_pos, u_neg)`` [B, P + M] are given or drawn from ``generator``; the
    slots' order breaks ties by u_pos / 2, since the JAX sampler's tie-break
    draw takes the key of its positives' draw."""
    all_boxes = torch.cat([proposals, gt_boxes], 1)
    all_valid = torch.cat([prop_valid, gt_valid], 1)
    quality = pairwise_iou(gt_boxes, all_boxes)  # [B, M, P + M]
    # an invalid proposal never matches
    quality = torch.where(all_valid[:, None, :], quality, -1.0)
    matched = M.match(quality, gt_valid, cfg.fg_iou_thresh, cfg.bg_iou_thresh, False)
    midx = matched.clamp(min=0)
    labels = gather_rows(gt_labels.long(), midx)
    labels = torch.where(matched == M.BELOW_LOW_THRESHOLD, 0, labels)
    labels = torch.where(matched == M.BETWEEN_THRESHOLDS, -1, labels)
    labels = torch.where(all_valid, labels, -1)  # padding: ignored

    if uniforms is None:
        uniforms = sampler_uniforms(labels.shape, labels.device, generator)
    pos_mask, neg_mask = balanced_sample(labels, cfg.batch_size_per_image,
                                         cfg.positive_fraction, uniforms)
    sampled = pos_mask | neg_mask
    # the sampled slots first (positives, then negatives)
    rank_key = pos_mask * 2.0 + neg_mask * 1.0 + uniforms[0] * 0.5
    order = torch.sort(-rank_key, dim=1, stable=True).indices[:, :cfg.batch_size_per_image]

    s_boxes = gather_rows(all_boxes, order)
    s_labels, s_matched, s_pos, s_sampled = (gather_rows(t, order)
                                             for t in (labels, midx, pos_mask, sampled))
    reg_targets = encode_boxes(gather_rows(gt_boxes, s_matched), s_boxes, cfg.box_weights)
    # Non-positive slots may match a zero box (a background image): their
    # targets are inf or NaN and never read, but inf * 0 is NaN in a sum.
    reg_targets = torch.where(s_pos[..., None], torch.nan_to_num(reg_targets), 0.0)
    s_labels = torch.where(s_sampled, s_labels, 0)
    return s_boxes, s_labels, reg_targets, s_pos, s_sampled, s_matched


def training_tfidf_scale(gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                         cfg: RoIHeadsConfig, tfidf=None):
    """The logit scale inside the training classification loss: the
    dataset's tfidf vector, or with ``cfg.tfidf_mini_batch`` the minibatch
    idf, Lp-normalized when ``cfg.tfidf_norm``."""
    if cfg.tfidf_mini_batch:
        scale = minibatch_idf(gt_labels, gt_valid, cfg.num_classes)
        if cfg.tfidf_norm:
            scale = scale / torch.linalg.vector_norm(scale, ord=cfg.tfidf_norm)
        return scale
    return 1.0 if tfidf is None else tfidf


def _gombit_prob(logits: torch.Tensor) -> torch.Tensor:
    """Gompertz-link probability: x = clip(logits - 1.96, -3, 5),
    p = exp(-exp(-x))."""
    x = (logits - 1.96).clamp(-3.0, 5.0)
    return torch.exp(-torch.exp(-x))


def fastrcnn_loss(class_logits: torch.Tensor, box_regression: torch.Tensor,
                  labels: torch.Tensor, reg_targets: torch.Tensor, sampled_mask: torch.Tensor,
                  cfg: RoIHeadsConfig, class_weights: torch.Tensor | None = None) -> dict:
    """class_logits [B, S, C] (tf-idf scaled by the caller), box_regression
    [B, S, 4C], labels [B, S] (0 background), targets [B, S, 4], sampled
    [B, S] -> dict(loss_classifier, loss_box_reg), over the number sampled."""
    bsz, s, c = class_logits.shape
    # the global batch's count; each rank returns its share (parallel/mesh.py)
    num_sampled = mesh.global_sum(sampled_mask.sum()).clamp(min=1).to(class_logits.dtype)
    smask = sampled_mask.to(class_logits.dtype)
    if cfg.loss_type == "ce":
        weight = (class_weights if class_weights is not None
                  else torch.ones(c, dtype=class_logits.dtype, device=class_logits.device))
        cls_loss = L.weighted_ce_mean(class_logits.reshape(-1, c), labels.reshape(-1), weight,
                                      sample_mask=smask.reshape(-1))
    else:
        onehot = L.one_hot(labels, c, class_logits.dtype)
        onehot[..., 0] = 0.0  # background column zeroed
        if cfg.loss_type == "bce":
            el = L.sigmoid_binary_cross_entropy(class_logits, onehot)
        elif cfg.loss_type == "focal_loss":
            el = L.sigmoid_focal_loss(class_logits, onehot)
        elif cfg.loss_type in ("gombit", "gombit_fl"):
            p = _gombit_prob(class_logits).clamp(1e-7, 1 - 1e-7)
            el = -(onehot * torch.log(p) + (1 - onehot) * torch.log1p(-p))
            if cfg.loss_type == "gombit_fl":
                p_t = p * onehot + (1 - p) * (1 - onehot)
                alpha_t = 0.25 * onehot + 0.75 * (1 - onehot)
                el = alpha_t * el * (1 - p_t) ** 2
        else:
            raise ValueError(f"unknown loss_type {cfg.loss_type!r}")
        cls_loss = mesh.rank_share((el * smask[..., None]).sum() / num_sampled)

    # box loss over the positives, at the GT class's deltas
    lab_c = labels.long().clamp(min=0)
    reg_at_label = box_regression.reshape(bsz, s, c, 4).gather(
        2, lab_c[..., None, None].expand(bsz, s, 1, 4))[:, :, 0]
    pos = (labels > 0).to(class_logits.dtype) * smask
    box_l = L.smooth_l1_loss(reg_at_label, reg_targets).sum(-1)
    return {"loss_classifier": cls_loss,
            "loss_box_reg": mesh.rank_share((box_l * pos).sum() / num_sampled)}


def postprocess_detections(class_logits: torch.Tensor, box_regression: torch.Tensor,
                           proposals: torch.Tensor, prop_valid: torch.Tensor, image_size,
                           cfg: RoIHeadsConfig, tfidf_post: torch.Tensor | float = 1.0):
    """class_logits [B, P, C], box_regression [B, P, 4C], proposals [B, P, 4],
    prop_valid [B, P] -> (boxes [B, D, 4], scores [B, D], labels [B, D]
    1-based, -1 where not valid; valid [B, D])."""
    b, p, c = class_logits.shape
    scaled = class_logits * tfidf_post
    if cfg.loss_type == "ce":
        scores = torch.softmax(scaled, -1)
    elif cfg.loss_type in ("gombit", "gombit_fl"):
        scores = _gombit_prob(scaled)
    elif cfg.loss_type in ("bce", "focal_loss"):
        scores = torch.sigmoid(scaled)
    else:
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")
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
