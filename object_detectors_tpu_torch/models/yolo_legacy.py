"""Legacy per-scale YOLO loss and decoder (port of the JAX package's
``models/yolo_legacy.py``, the reference's ``yolo/nets/yolo_loss.py``).

Differences from the production criterion (``yolo_criterion.py``):

* one scale at a time, with grid targets [B, H, W, A] built by scatter;
* anchor matching by the shape-only IoU of (0, 0, gw, gh) against the
  anchors at the origin, each GT claiming its best anchor at its centre
  cell;
* mean-reduced BCE (xy, conf, cls) and MSE (wh) over the positive and the
  no-object cells;
* the eval decode returns [B, A*H*W, 5+C] in (a, h, w) order with absolute
  pixel boxes.

Raw maps are NHWC ``[B, H, W, A*(5+C)]``, as ``YoloHead`` gives them. The
JAX targets are ``.at[...]`` writes whose padded GT rows go out of bounds
and are dropped (``mode="drop"``). Here every write has an index in range:
a padded row, and a GT whose cell and anchor a later GT of the same image
claims again, is sent to one spare slot past the grid, which is cut off.
That keeps the JAX order, where the last of several GTs on one cell wins,
and indexes nothing out of range (CUDA asserts on that).
"""

from __future__ import annotations

import dataclasses

import torch

from object_detectors_tpu_torch.ops import losses as L


@dataclasses.dataclass(frozen=True)
class YoloLegacyConfig:
    num_classes: int = 80
    img_size: int = 416
    anchors: tuple = ((116, 90), (156, 198), (373, 326))  # this scale's
    ignore_threshold: float = 0.5
    lambda_xy: float = 2.5
    lambda_wh: float = 2.5
    lambda_conf: float = 1.0
    lambda_no_conf: float = 0.1
    lambda_cls: float = 1.0


def _shape_iou(gt_wh: torch.Tensor, anchor_wh: torch.Tensor) -> torch.Tensor:
    """IoU of origin-anchored boxes: [..., M, 2] x [A, 2] -> [..., M, A]."""
    inter = (torch.minimum(gt_wh[..., None, 0], anchor_wh[:, 0])
             * torch.minimum(gt_wh[..., None, 1], anchor_wh[:, 1]))
    area_g = gt_wh[..., 0] * gt_wh[..., 1]
    area_a = anchor_wh[:, 0] * anchor_wh[:, 1]
    return inter / (area_g[..., None] + area_a - inter + 1e-16)


def _scatter(slots: int, index: torch.Tensor, values, fill, dtype, reduce=None):
    """[B, slots] filled with ``fill``, ``values`` [B, M] written at
    ``index`` [B, M] (``slots`` is the spare slot, cut off after)."""
    b = index.shape[0]
    out = torch.full((b, slots + 1), fill, dtype=dtype, device=index.device)
    values = torch.as_tensor(values, dtype=dtype, device=index.device).expand(index.shape)
    if reduce is None:
        out.scatter_(1, index, values)
    else:
        out.scatter_reduce_(1, index, values, reduce)
    return out[:, :slots]


def _targets_one(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, gt_labels: torch.Tensor,
                 in_hw, scaled_anchors: torch.Tensor, num_classes: int,
                 ignore_threshold: float = 0.5):
    """Grid targets of a batch. gt_boxes [B, M, 4] relative cxcywh ->
    (mask, noobj, tx, ty, tw, th) [B, H, W, A] and tcls [B, H, W, A, C]
    (the JAX function maps one image; this one takes the batch)."""
    h, w = in_hw
    a = scaled_anchors.shape[0]
    b, m = gt_valid.shape
    gx = torch.clamp(gt_boxes[..., 0] * w, 0, w - 1e-4)
    gy = torch.clamp(gt_boxes[..., 1] * h, 0, h - 1e-4)
    gw = gt_boxes[..., 2] * w
    gh = gt_boxes[..., 3] * h
    gi = gx.to(torch.int64)
    gj = gy.to(torch.int64)

    iou = _shape_iou(torch.stack([gw, gh], -1), scaled_anchors)  # [B, M, A]
    best = torch.argmax(iou, -1)
    cells = h * w * a
    cell = (gj * w + gi) * a                                     # [B, M]
    slot = torch.where(gt_valid, cell + best, cells)
    # the last GT on a (cell, anchor) writes it: an earlier one goes spare
    later = torch.triu(torch.ones(m, m, dtype=torch.bool, device=slot.device), 1)
    shadowed = ((slot[:, :, None] == slot[:, None, :]) & later).any(-1)
    last = torch.where(shadowed, cells, slot)

    # ignore: anchors whose shape IoU with a GT passes the threshold at that
    # GT's cell leave the no-object set (a min over the GTs: order-free)
    anchor_slots = torch.where(gt_valid[..., None], cell[..., None] + torch.arange(
        a, device=slot.device), cells).reshape(b, m * a)
    keep = (~(iou > ignore_threshold)).reshape(b, m * a)
    noobj = _scatter(cells, anchor_slots, keep, 1, torch.uint8, "amin").bool()
    mask = _scatter(cells, slot, True, False, torch.bool)
    noobj = noobj & ~mask

    f32 = gt_boxes.dtype
    tx = _scatter(cells, last, gx - gi, 0.0, f32)
    ty = _scatter(cells, last, gy - gj, 0.0, f32)
    anchor_w = scaled_anchors[best, 0]
    anchor_h = scaled_anchors[best, 1]
    tw = _scatter(cells, last, torch.log(gw / anchor_w + 1e-16), 0.0, f32)
    th = _scatter(cells, last, torch.log(gh / anchor_h + 1e-16), 0.0, f32)
    # every write of the class grid is a one: order-free
    cls_slot = torch.where(gt_valid, (cell + best) * num_classes
                           + gt_labels.clamp(0, num_classes - 1), cells * num_classes)
    tcls = _scatter(cells * num_classes, cls_slot, 1.0, 0.0, f32)
    grid = (b, h, w, a)
    return (mask.reshape(grid), noobj.reshape(grid), tx.reshape(grid), ty.reshape(grid),
            tw.reshape(grid), th.reshape(grid), tcls.reshape(*grid, num_classes))


def yolo_legacy_loss(raw: torch.Tensor, gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_valid: torch.Tensor, cfg: YoloLegacyConfig):
    """raw: one scale's NHWC output [B, H, W, A*(5+C)].

    Returns (loss, (loss_x, loss_y, loss_w, loss_h, loss_conf, loss_cls)),
    the 7-tuple of the reference's yolo_loss.py."""
    b, h, w, _ = raw.shape
    a = len(cfg.anchors)
    pred = raw.reshape(b, h, w, a, 5 + cfg.num_classes)
    stride = cfg.img_size / w
    scaled = torch.tensor(cfg.anchors, dtype=torch.float32, device=raw.device) / stride

    mask, noobj, tx, ty, tw, th, tcls = _targets_one(
        gt_boxes, gt_valid, gt_labels, (h, w), scaled, cfg.num_classes, cfg.ignore_threshold)
    m = mask.to(raw.dtype)
    nm = noobj.to(raw.dtype)
    n_pos = torch.clamp(m.sum(), min=1.0)
    n_neg = torch.clamp(nm.sum(), min=1.0)

    def masked_mean(el, msk, count):
        return (el * msk).sum() / count

    bce = L.sigmoid_binary_cross_entropy
    loss_x = masked_mean(bce(pred[..., 0], tx), m, n_pos)
    loss_y = masked_mean(bce(pred[..., 1], ty), m, n_pos)
    loss_w = masked_mean((pred[..., 2] - tw) ** 2, m, n_pos)
    loss_h = masked_mean((pred[..., 3] - th) ** 2, m, n_pos)
    loss_conf = (cfg.lambda_conf * masked_mean(bce(pred[..., 4], torch.ones_like(pred[..., 4])),
                                               m, n_pos)
                 + cfg.lambda_no_conf * masked_mean(
                     bce(pred[..., 4], torch.zeros_like(pred[..., 4])), nm, n_neg))
    cls_el = bce(pred[..., 5:], tcls)
    loss_cls = (cls_el * m[..., None]).sum() / (n_pos * cfg.num_classes)
    loss = ((loss_x + loss_y) * cfg.lambda_xy + (loss_w + loss_h) * cfg.lambda_wh + loss_conf
            + loss_cls * cfg.lambda_cls)
    return loss, (loss_x, loss_y, loss_w, loss_h, loss_conf, loss_cls)


def yolo_legacy_decode(raw: torch.Tensor, cfg: YoloLegacyConfig) -> torch.Tensor:
    """One scale NHWC [B, H, W, A*(5+C)] -> [B, A*H*W, 5+C] absolute pixel
    boxes (cx, cy, w, h), confidence and class scores in the legacy (a, h,
    w) order."""
    b, h, w, _ = raw.shape
    a = len(cfg.anchors)
    attrs = 5 + cfg.num_classes
    stride = cfg.img_size / w
    pred = raw.reshape(b, h, w, a, attrs).permute(0, 3, 1, 2, 4)
    gx = torch.arange(w, dtype=raw.dtype, device=raw.device)[None, None, None, :]
    gy = torch.arange(h, dtype=raw.dtype, device=raw.device)[None, None, :, None]
    anchors = torch.tensor(cfg.anchors, dtype=raw.dtype, device=raw.device) / stride
    aw = anchors[:, 0][None, :, None, None]
    ah = anchors[:, 1][None, :, None, None]
    x = (torch.sigmoid(pred[..., 0]) + gx) * stride
    y = (torch.sigmoid(pred[..., 1]) + gy) * stride
    bw = torch.exp(pred[..., 2]) * aw * stride
    bh = torch.exp(pred[..., 3]) * ah * stride
    conf = torch.sigmoid(pred[..., 4])
    cls = torch.sigmoid(pred[..., 5:])
    out = torch.cat([torch.stack([x, y, bw, bh, conf], -1), cls], -1)
    return out.reshape(b, a * h * w, attrs)
