"""SSD300 with a VGG16 trunk, its loss and postprocess (port of the JAX
package's ``models/ssd.py``, torchvision SSD semantics).

* ``VGGFeatureExtractor``: the VGG16 convs through conv4_3 (the third pool
  in ceil mode: an edge pad to even size, then the pool), conv4_3
  L2-normalized in f32 and scaled by the learned ``scale_weight`` (38x38 at
  300²); the conv5 block, a 3x3 / stride 1 pool, conv6 (1024, dilation 6)
  and conv7 1x1 (19x19); the extra blocks conv8_2 and conv9_2 (stride 2)
  and conv10_2 and conv11_2 (3x3 without padding). Padding is Flax's
  "SAME": at stride 2 on an even size it is one pixel at the end only.
* ``SSDHead``: per level a 3x3 class conv (A x C) and a box conv (A x 4),
  flattened in (h, w, a) order.
* ``ssd_loss``: ``ssd_match`` at 0.5 (each GT forces its best default
  box); smooth-L1 over the foreground; CE of the (tf-idf scaled) logits over
  the foreground and the hardest negatives, three per positive, ranked by a
  stable double argsort; both over the batch's foreground count.
* ``ssd_postprocess``: softmax scores, per class the top
  ``topk_candidates`` above 0.01, a global top-k cap, class-aware NMS at
  0.45 (the NMS kernel on the card), 200 kept. Ties in every top-k go to
  the lowest index, as ``lax.top_k``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.data.idf import minibatch_idf
from object_detectors_tpu_torch.ops import losses as L
from object_detectors_tpu_torch.ops.boxes import (
    clip_boxes_to_image, decode_boxes, encode_boxes, pairwise_iou,
)
from object_detectors_tpu_torch.ops.matcher import ssd_match
from object_detectors_tpu_torch.ops.nms import batched_nms, gather_rows, topk_lowest_index
from object_detectors_tpu_torch.parallel import mesh

ANCHORS_PER_LOCATION = (4, 6, 6, 6, 4, 4)


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    num_classes: int = 91
    iou_thresh: float = 0.5
    score_thresh: float = 0.01
    nms_thresh: float = 0.45
    detections_per_img: int = 200
    topk_candidates: int = 400
    neg_to_pos_ratio: int = 3
    box_weights: tuple = (10.0, 10.0, 5.0, 5.0)
    # training logit scale recomputed from the minibatch, as RetinaNet's
    tfidf_mini_batch: bool = False
    tfidf_norm: int = 0


class SameConv(nn.Conv2d):
    """A conv with Flax's padding: "SAME" (total max((out - 1) * stride +
    extent - size, 0), the odd pixel at the end) or "VALID"; run in the
    dtype of its input."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, padding: str = "SAME"):
        super().__init__(in_channels, out_channels, kernel_size, stride, 0, dilation)
        self.same = padding == "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        if self.same:
            extent = (self.kernel_size[0] - 1) * self.dilation[0] + 1
            s = self.stride[0]
            for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
                total = max((-(-n // s) - 1) * s + extent - n, 0)
                pads += [total // 2, total - total // 2]
        pad = 0
        if pads and pads[0::2] == pads[1::2] and pads[0] == pads[2]:
            pad = pads[0]  # symmetric: the conv pads
        elif any(pads):
            x = F.pad(x, pads)
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride, pad,
                        self.dilation)


class VGGFeatureExtractor(nn.Module):
    """NCHW images -> the six SSD300 level maps."""

    def __init__(self):
        super().__init__()
        cin = 3
        for bi, (f, reps) in enumerate([(64, 2), (128, 2), (256, 3), (512, 3)]):
            for r in range(reps):
                self.add_module(f"conv{bi + 1}_{r + 1}", SameConv(cin, f, 3))
                cin = f
        for r in range(3):
            self.add_module(f"conv5_{r}", SameConv(512, 512, 3))
        self.conv6 = SameConv(512, 1024, 3, dilation=6)
        self.conv7 = SameConv(1024, 1024, 1)
        self.conv8_1 = SameConv(1024, 256, 1)
        self.conv8_2 = SameConv(256, 512, 3, stride=2)
        self.conv9_1 = SameConv(512, 128, 1)
        self.conv9_2 = SameConv(128, 256, 3, stride=2)
        self.conv10_1 = SameConv(256, 128, 1)
        self.conv10_2 = SameConv(128, 256, 3, padding="VALID")
        self.conv11_1 = SameConv(256, 128, 1)
        self.conv11_2 = SameConv(128, 256, 3, padding="VALID")
        self.scale_weight = nn.Parameter(torch.full((512,), 20.0))

    def forward(self, x: torch.Tensor):
        for bi, reps in enumerate((2, 2, 3, 3)):
            for r in range(reps):
                x = F.relu(getattr(self, f"conv{bi + 1}_{r + 1}")(x))
            if bi < 2:
                x = F.max_pool2d(x, 2, 2)
            elif bi == 2:
                # ceil mode: an edge pad to even size, then the pool
                x = F.pad(x, (0, x.shape[3] % 2, 0, x.shape[2] % 2), mode="replicate")
                x = F.max_pool2d(x, 2, 2)
        norm = x.float().pow(2).sum(1, keepdim=True).sqrt() + 1e-12
        f38 = (x / norm.to(x.dtype)) * self.scale_weight.to(x.dtype)[None, :, None, None]
        x = F.max_pool2d(x, 2, 2)
        for r in range(3):
            x = F.relu(getattr(self, f"conv5_{r}")(x))
        x = F.max_pool2d(x, 3, 1, 1)  # the padding takes no part in the max
        x = F.relu(self.conv6(x))
        f19 = F.relu(self.conv7(x))
        f10 = F.relu(self.conv8_2(F.relu(self.conv8_1(f19))))
        f5 = F.relu(self.conv9_2(F.relu(self.conv9_1(f10))))
        f3 = F.relu(self.conv10_2(F.relu(self.conv10_1(f5))))
        f1 = F.relu(self.conv11_2(F.relu(self.conv11_1(f3))))
        return [f38, f19, f10, f5, f3, f1]


class SSDHead(nn.Module):
    def __init__(self, num_classes: int, in_channels=(512, 1024, 512, 256, 256, 256),
                 anchors_per_location=ANCHORS_PER_LOCATION):
        super().__init__()
        self.num_classes = num_classes
        for i, (c, a) in enumerate(zip(in_channels, anchors_per_location)):
            self.add_module(f"cls{i}", SameConv(c, a * num_classes, 3))
            self.add_module(f"reg{i}", SameConv(c, a * 4, 3))

    def forward(self, features):
        """NCHW level maps -> (cls_logits [B, A_total, C], bbox_reg
        [B, A_total, 4], anchors per level)."""
        cls, reg = [], []
        for i, f in enumerate(features):
            b = f.shape[0]
            cls.append(getattr(self, f"cls{i}")(f).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes))
            reg.append(getattr(self, f"reg{i}")(f).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(cls, 1), torch.cat(reg, 1), tuple(c.shape[1] for c in cls)


class SSD300(nn.Module):
    """Images [B, H, W, 3] (normalized) -> (cls_logits, bbox_reg,
    level_sizes), activations in ``dtype``."""

    def __init__(self, cfg: SSDConfig = SSDConfig(), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.backbone = VGGFeatureExtractor()
        self.head = SSDHead(cfg.num_classes)

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        return self.head(self.backbone(x.contiguous(memory_format=torch.channels_last)))


@torch.no_grad()
def init_ssd_(model: SSD300, seed: int = 0) -> SSD300:
    """Random init from a seeded ``torch.Generator`` on the CPU at Flax's
    LeCun-normal scale, zero biases, ``scale_weight`` 20."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * m.weight[0].numel() ** -0.5)
            m.bias.zero_()
    model.backbone.scale_weight.fill_(20.0)
    return model


def ssd_loss(cls_logits: torch.Tensor, bbox_reg: torch.Tensor, anchors: torch.Tensor,
             gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
             cfg: SSDConfig, tfidf=1.0) -> dict:
    """cls_logits [B, A, C] f32, bbox_reg [B, A, 4], default boxes [A, 4]
    xyxy, GT boxes [B, M, 4], labels [B, M] 1-based (0 background), valid
    [B, M] -> dict(bbox_regression, classification)."""
    c = cls_logits.shape[-1]
    if cfg.tfidf_mini_batch:
        tfidf = minibatch_idf(gt_labels, gt_valid, c)
        if cfg.tfidf_norm:
            tfidf = tfidf / torch.linalg.vector_norm(tfidf, ord=cfg.tfidf_norm)
    matched = ssd_match(pairwise_iou(gt_boxes, anchors), gt_valid, cfg.iou_thresh)  # [B, A]
    fg = matched >= 0
    # the global batch's count; each rank returns its share (parallel/mesh.py)
    num_fg = mesh.global_sum(fg.sum()).clamp(min=1).to(cls_logits.dtype)
    midx = matched.clamp(min=0)
    reg_t = encode_boxes(gather_rows(gt_boxes, midx), anchors[None], cfg.box_weights)
    reg_t = torch.where(fg[..., None], torch.nan_to_num(reg_t), 0.0)
    box_l = L.smooth_l1_loss(bbox_reg, reg_t).sum(-1)
    bbox_loss = (box_l * fg).sum() / num_fg

    cls_t = torch.where(fg, torch.gather(gt_labels.long(), 1, midx), 0)
    ce = L.softmax_cross_entropy(cls_logits * tfidf, cls_t)  # [B, A]
    # hard negatives: the rank of each anchor by its CE among the
    # negatives, from a stable double argsort (the inverse permutation)
    neg_loss = torch.where(fg, float("-inf"), ce)
    order = torch.sort(-neg_loss, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    num_neg = cfg.neg_to_pos_ratio * fg.sum(1, keepdim=True)
    bg = rank < num_neg
    cls_loss = ((ce * fg).sum() + torch.where(bg & ~fg, ce, 0.0).sum()) / num_fg
    return {"bbox_regression": mesh.rank_share(bbox_loss),
            "classification": mesh.rank_share(cls_loss)}


def ssd_postprocess(cls_logits: torch.Tensor, bbox_reg: torch.Tensor, anchors: torch.Tensor,
                    image_size, cfg: SSDConfig, tfidf_post=1.0):
    """-> (boxes [B, D, 4], scores [B, D], labels [B, D] (-1 where not
    valid), valid [B, D]), D = ``detections_per_img``."""
    b, a, c = cls_logits.shape
    k = min(cfg.topk_candidates, a)
    scores = torch.softmax(cls_logits * tfidf_post, -1)
    boxes = clip_boxes_to_image(decode_boxes(bbox_reg, anchors[None], cfg.box_weights),
                                image_size)
    sc = scores[..., 1:]
    masked = torch.where(sc > cfg.score_thresh, sc, float("-inf"))
    topv, topi = topk_lowest_index(masked.transpose(1, 2), k)  # [B, C - 1, k]
    flat_scores = topv.reshape(b, -1)
    flat_boxes = gather_rows(boxes, topi.reshape(b, -1))
    flat_labels = torch.arange(1, c, dtype=torch.int32, device=cls_logits.device)
    flat_labels = flat_labels.repeat_interleave(k).expand(b, -1)
    valid = torch.isfinite(flat_scores)
    # the NMS input: exact while detections_per_img survivors lie in this prefix
    cap = min(4 * cfg.detections_per_img + cfg.topk_candidates, flat_scores.shape[1])
    gv, gi = topk_lowest_index(torch.where(valid, flat_scores, float("-inf")), cap)
    live = torch.isfinite(gv)
    ob, osc, olab, _, ovalid = batched_nms(
        gather_rows(flat_boxes, gi), torch.where(live, gv, 0.0), torch.gather(flat_labels, 1, gi),
        cfg.nms_thresh, cfg.detections_per_img, live)
    return ob, osc, olab, ovalid
