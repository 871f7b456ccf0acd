"""RetinaNet with a ResNet-FPN backbone (port of the JAX package's
``models/retinanet.py``, torchvision RetinaNet semantics).

Backbone: ResNet (frozen BN, the ``fused`` knob of ``models/resnet.py``) ->
FPN 256 over C3..C5 with P6/P7 from P5. Head: shared 4 x (3x3 conv + ReLU)
towers per level, then 3x3 class (A*K) and box (A*4) convs, flattened to
[B, sum_l H_l*W_l*A, K] and [B, ..., 4] in (h, w, a) order. The JAX package
also runs the towers once over a packed canvas of all levels (a TPU device,
numerically the same); the port runs them level by level.

Postprocess (``retinanet_postprocess``), per level: score threshold 0.05,
the top-``topk_candidates`` (anchor, class) pairs; over all levels: the
top-``pre_nms_candidates`` cap, decode against the anchors, clip,
class-aware NMS, ``detections_per_img`` kept. The JAX function's ``fused``
select is ported; its ``perlevel`` and ``batched`` modes compute the same
outputs and are not. The loss comes with the training slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.data.idf import minibatch_idf
from object_detectors_tpu_torch.models.common import conv2d
from object_detectors_tpu_torch.models.resnet import BackboneWithFPN, ResNet
from object_detectors_tpu_torch.ops import losses as L
from object_detectors_tpu_torch.ops import matcher as M
from object_detectors_tpu_torch.ops.boxes import (
    clip_boxes_to_image, decode_boxes, encode_boxes, pairwise_iou,
)
from object_detectors_tpu_torch.ops.nms import batched_nms, gather_rows
from object_detectors_tpu_torch.ops.selection import radix_topk, radix_topk_multi


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    """The JAX ``RetinaNetConfig``."""

    num_classes: int = 91
    fg_iou_thresh: float = 0.5
    bg_iou_thresh: float = 0.4
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 300
    topk_candidates: int = 1000
    # global pre-NMS cap over the concatenated levels; 0 disables
    pre_nms_candidates: int = 2000
    box_weights: tuple = (1.0, 1.0, 1.0, 1.0)
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    # training logit scale recomputed from the minibatch, log((B+1)/(df+1))+1,
    # optionally Lp-normalized (p = tfidf_norm, 0 = off)
    tfidf_mini_batch: bool = False
    tfidf_norm: int = 0


class RetinaNetHead(nn.Module):
    """Class and box towers shared across the FPN levels. Submodule names
    follow the Flax names (``cls_conv{i}``, ``reg_conv{i}``, ``cls_logits``,
    ``bbox_reg``)."""

    def __init__(self, num_classes: int, num_anchors: int = 9, in_channels: int = 256,
                 prior_probability: float = 0.01):
        super().__init__()
        self.num_classes = num_classes
        self.prior_probability = prior_probability
        for i in range(4):
            self.add_module(f"cls_conv{i}", nn.Conv2d(in_channels, in_channels, 3, padding=1))
            self.add_module(f"reg_conv{i}", nn.Conv2d(in_channels, in_channels, 3, padding=1))
        self.cls_logits = nn.Conv2d(in_channels, num_anchors * num_classes, 3, padding=1)
        self.bbox_reg = nn.Conv2d(in_channels, num_anchors * 4, 3, padding=1)

    def _tower(self, x: torch.Tensor, name: str, out: nn.Conv2d, width: int) -> torch.Tensor:
        for i in range(4):
            x = F.relu(conv2d(x, getattr(self, f"{name}{i}")))
        return conv2d(x, out).permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)

    def forward(self, features):
        """NCHW level maps -> (cls_logits [B, A_total, K], bbox_reg
        [B, A_total, 4], anchors per level)."""
        cls = [self._tower(f, "cls_conv", self.cls_logits, self.num_classes) for f in features]
        reg = [self._tower(f, "reg_conv", self.bbox_reg, 4) for f in features]
        return torch.cat(cls, 1), torch.cat(reg, 1), tuple(c.shape[1] for c in cls)


class RetinaNet(nn.Module):
    """Images [B, H, W, 3] (the JAX layout, normalized) -> (cls_logits,
    bbox_reg, level_sizes), activations in ``dtype``."""

    def __init__(self, num_classes: int = 91, resnet_layers=(3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32, backbone_fused: str = "off"):
        super().__init__()
        self.dtype = dtype
        self.backbone = BackboneWithFPN(ResNet(resnet_layers, fused=backbone_fused), 256,
                                        extra_blocks="p6p7", returned_layers=(2, 3, 4))
        self.head = RetinaNetHead(num_classes)

    def forward(self, images: torch.Tensor, train: bool = False, on_stage=None):
        """``on_stage(name)``, when given, is called after each stage.
        ``train`` (a forward for the loss) needs the module in training
        mode: in eval mode the backbone may take the fused forward-only
        blocks, which pass no gradient."""
        if train and not self.training:
            raise ValueError("train=True needs the module in training mode (model.train())")
        mark = on_stage or (lambda name: None)
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        feats = self.backbone(x.contiguous(memory_format=torch.channels_last))
        mark("backbone+FPN")
        out = self.head(feats)
        mark("head")
        return out


@torch.no_grad()
def init_retinanet_(model: RetinaNet, seed: int = 0) -> RetinaNet:
    """Random init from a seeded ``torch.Generator`` on the CPU, with the
    Flax initializers' scales: normal 0.01 for the head's convs, the class
    bias at -log((1 - p) / p) with p = 0.01, LeCun-normal elsewhere, zero
    biases, identity frozen batch norm."""
    g = torch.Generator().manual_seed(seed)
    head = set(model.head.modules())
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = 0.01 if m in head else m.weight[0].numel() ** -0.5
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * std)
            if m.bias is not None:
                m.bias.zero_()
    p = model.head.prior_probability
    model.head.cls_logits.bias.fill_(-math.log((1 - p) / p))
    return model


def _match_per_image(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor,
                     cfg: RetinaNetConfig) -> torch.Tensor:
    """GT [..., M, 4] with validity [..., M] against anchors [A, 4] ->
    matches [..., A] (a GT index, -1 below, -2 between the thresholds)."""
    return M.match(pairwise_iou(gt_boxes, anchors), gt_valid, cfg.fg_iou_thresh,
                   cfg.bg_iou_thresh, allow_low_quality_matches=True)


def retinanet_loss(cls_logits: torch.Tensor, bbox_reg: torch.Tensor, anchors: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                   cfg: RetinaNetConfig, tfidf=1.0) -> dict:
    """cls_logits [B, A, K] f32, bbox_reg [B, A, 4], anchors [A, 4], GT boxes
    [B, M, 4] xyxy, labels [B, M] (0-based), valid [B, M] ->
    dict(classification, bbox_regression)."""
    k = cls_logits.shape[-1]
    if cfg.tfidf_mini_batch:
        tfidf = minibatch_idf(gt_labels, gt_valid, k)
        if cfg.tfidf_norm:
            tfidf = tfidf / torch.linalg.vector_norm(tfidf, ord=cfg.tfidf_norm)
    matched = _match_per_image(gt_boxes, gt_valid, anchors, cfg)  # [B, A]
    fg = matched >= 0
    valid = matched != M.BETWEEN_THRESHOLDS
    num_fg = fg.sum(1).clamp(min=1).to(cls_logits.dtype)
    midx = matched.clamp(min=0)
    target = L.one_hot(torch.gather(gt_labels.long(), 1, midx), k, cls_logits.dtype)
    target = target * fg[..., None]
    cls_el = L.sigmoid_focal_loss(cls_logits * tfidf, target, cfg.focal_alpha, cfg.focal_gamma)
    classification = ((cls_el * valid[..., None]).sum((1, 2)) / num_fg).mean()
    reg_target = encode_boxes(gather_rows(gt_boxes, midx), anchors[None], cfg.box_weights)
    reg_el = (bbox_reg - reg_target).abs().sum(-1)
    bbox_regression = ((reg_el * fg).sum(1) / num_fg).mean()
    return {"classification": classification, "bbox_regression": bbox_regression}


def _select_fused(logits, level_sizes, cfg: RetinaNetConfig, tfidf, static: float | None):
    """A scalar tfidf: per level, the exact two-stage top-k in logit space
    (JAX ``select_fused``). Stage 1 keeps the top anchors by their best
    class, a superset of the anchors of the top (anchor, class) pairs;
    stage 2 takes the top pairs among them. With a positive Python scalar
    (``static``) the threshold is ``logit * tfidf > logit(thresh)`` and
    the logits stay in their dtype; a tensor scales them in f32 first.
    Sigmoid runs on the survivors only."""
    k = logits.shape[-1]
    thr = math.log(cfg.score_thresh / (1.0 - cfg.score_thresh))
    levels = []
    for lg in logits.split(level_sizes, 1):
        if static is not None:
            raw = torch.where(lg.float() * static > thr, lg, float("-inf"))
            scale = static
        else:
            raw = lg.float() * tfidf
            raw = torch.where(raw > thr, raw, float("-inf"))
            scale = 1.0
        levels.append((raw, min(cfg.topk_candidates, lg.shape[1] * k), scale))
    stage1 = radix_topk_multi([raw.amax(2) for raw, _, _ in levels],
                              [min(topk, raw.shape[1]) for raw, topk, _ in levels])
    subs = [gather_rows(raw, a_idx).flatten(1) for (raw, _, _), (_, a_idx) in zip(levels, stage1)]
    stage2 = radix_topk_multi(subs, [topk for _, topk, _ in levels])
    out, start = [], 0
    for (raw, _, scale), (_, a_idx), (topv, sub_i) in zip(levels, stage1, stage2):
        topi = torch.gather(a_idx, 1, sub_i // k) * k + sub_i % k
        fin = torch.isfinite(topv.float())
        scores = torch.where(fin, torch.sigmoid(topv.float() * scale), 0.0)
        out.append((scores, (topi % k).to(torch.int32), topi // k + start, fin))
        start += raw.shape[1]
    return [torch.cat(t, 1) for t in zip(*out)]


def _select_scaled(logits, level_sizes, cfg: RetinaNetConfig, tfidf):
    """A tfidf vector: per level, sigmoid of the scaled f32 logits, the
    threshold, then the top-k over all (anchor, class) pairs."""
    k = logits.shape[-1]
    out, start = [], 0
    for lg in logits.split(level_sizes, 1):
        scores = torch.sigmoid(lg.float() * tfidf).flatten(1)
        masked = torch.where(scores > cfg.score_thresh, scores, float("-inf"))
        topv, topi = radix_topk(masked, min(cfg.topk_candidates, scores.shape[1]))
        fin = torch.isfinite(topv)
        out.append((torch.where(fin, topv, 0.0), (topi % k).to(torch.int32), topi // k + start,
                    fin))
        start += lg.shape[1]
    return [torch.cat(t, 1) for t in zip(*out)]


def select_candidates(cls_logits: torch.Tensor, level_sizes, cfg: RetinaNetConfig,
                      tfidf_post=1.0):
    """The postprocess's select, dispatched on ``tfidf_post`` (see
    ``retinanet_postprocess``): (scores, labels, anchor indices, valid)
    [B, sum of the levels' top-k]."""
    if isinstance(tfidf_post, (int, float)) and tfidf_post > 0:
        return _select_fused(cls_logits, level_sizes, cfg, None, float(tfidf_post))
    tfidf = torch.as_tensor(tfidf_post, dtype=torch.float32, device=cls_logits.device)
    if tfidf.dim() == 0:
        return _select_fused(cls_logits, level_sizes, cfg, tfidf, None)
    return _select_scaled(cls_logits, level_sizes, cfg, tfidf)


def cap_candidates(scores, labels, aidx, valid, cfg: RetinaNetConfig):
    """The global pre-NMS cap: the ``pre_nms_candidates`` best valid
    candidates over all levels (all of them when the cap is off or not
    smaller)."""
    if cfg.pre_nms_candidates and cfg.pre_nms_candidates < scores.shape[1]:
        _, keep = radix_topk(torch.where(valid, scores, float("-inf")), cfg.pre_nms_candidates)
        scores, labels, aidx, valid = (torch.gather(t, 1, keep)
                                       for t in (scores, labels, aidx, valid))
    return scores, labels, aidx, valid


def decode_candidates(bbox_reg: torch.Tensor, anchors: torch.Tensor, aidx: torch.Tensor,
                      image_size, cfg: RetinaNetConfig) -> torch.Tensor:
    """The candidates' boxes [B, N, 4]: their deltas and anchors gathered,
    decoded, clipped to the image."""
    boxes = decode_boxes(gather_rows(bbox_reg, aidx).float(), anchors[aidx], cfg.box_weights)
    return clip_boxes_to_image(boxes, image_size)


def retinanet_postprocess(cls_logits: torch.Tensor, bbox_reg: torch.Tensor,
                          anchors: torch.Tensor, level_sizes, image_size,
                          cfg: RetinaNetConfig, tfidf_post=1.0, on_stage=None):
    """cls_logits [B, A, K] (bf16 or f32), bbox_reg [B, A, 4], anchors [A, 4]
    -> (boxes [B, D, 4], scores [B, D], labels [B, D] (-1 where not valid),
    valid [B, D]), D = ``detections_per_img``. A positive Python scalar
    ``tfidf_post`` selects in logit space on the logits' own dtype, another
    scalar in f32 logit space, a vector on f32 sigmoid scores, as the JAX
    function dispatches. ``on_stage(name)`` is called after the select, the
    cap and decode, and the NMS."""
    mark = on_stage or (lambda name: None)
    scores, labels, aidx, valid = select_candidates(cls_logits, level_sizes, cfg, tfidf_post)
    mark("select")
    scores, labels, aidx, valid = cap_candidates(scores, labels, aidx, valid, cfg)
    boxes = decode_candidates(bbox_reg, anchors, aidx, image_size, cfg)
    mark("cap+decode")
    out_boxes, out_scores, out_labels, _, out_valid = batched_nms(
        boxes, scores, labels, cfg.nms_thresh, cfg.detections_per_img, valid)
    mark("NMS")
    return out_boxes, out_scores, out_labels, out_valid
