"""Box geometry (port of the JAX package's ``ops/boxes.py``): ``area``,
``pairwise_iou``, the clip / small-box mask of the proposal filter and the
BoxCoder decode. Same EPS and the same formulas in the same order, so that
IoU > threshold decisions and decoded boxes agree with the reference."""

from __future__ import annotations

import math

import torch

EPS = 1e-16


def area(box_xyxy: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [...] area (no clamping; degenerate boxes give <= 0)."""
    return (box_xyxy[..., 2] - box_xyxy[..., 0]) * (box_xyxy[..., 3] - box_xyxy[..., 1])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[..., M, 4] x [..., N, 4] xyxy -> [..., M, N] IoU (torchvision
    box_iou semantics with EPS in the union; leading dims broadcast)."""
    a1 = area(boxes1)
    a2 = area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (a1[..., :, None] + a2[..., None, :] - inter + EPS)


def clip_boxes_to_image(boxes: torch.Tensor, size_hw) -> torch.Tensor:
    """Clamp xyxy boxes to [0, W] x [0, H] (torchvision clip semantics)."""
    h, w = size_hw
    x = boxes[..., 0::2].clamp(0, w)
    y = boxes[..., 1::2].clamp(0, h)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True for boxes with both sides >= min_size (remove_small_boxes as a
    mask)."""
    ws = boxes[..., 2] - boxes[..., 0]
    hs = boxes[..., 3] - boxes[..., 1]
    return (ws >= min_size) & (hs >= min_size)


BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def decode_boxes(rel_codes: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 bbox_xform_clip: float = BBOX_XFORM_CLIP) -> torch.Tensor:
    """Weighted (dx, dy, dw, dh) deltas [..., 4] against xyxy boxes [..., 4]
    -> xyxy; the exp inputs are clipped at log(1000/16)."""
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    # a tensor divisor: the GPU would multiply by the reciprocal of a number;
    # filled on the device, as a copy from a host list waits for the device
    codes = rel_codes / torch.stack([torch.full((), w, dtype=rel_codes.dtype,
                                                device=rel_codes.device) for w in weights])
    dx = codes[..., 0]
    dy = codes[..., 1]
    dw = codes[..., 2].clamp(max=bbox_xform_clip)
    dh = codes[..., 3].clamp(max=bbox_xform_clip)

    pred_cx = dx * widths + ctr_x
    pred_cy = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                        pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], -1)
