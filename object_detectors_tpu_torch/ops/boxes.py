"""Box geometry (port of the JAX package's ``ops/boxes.py``): the format
converters, ``area``, ``pairwise_iou``, the IoU family ``box_iou`` (IoU,
GIoU, DIoU, CIoU), the clip / small-box mask of the proposal filter and the
BoxCoder encode and decode. Same EPS and the same formulas in the same
order, so that IoU > threshold decisions, losses and boxes agree with the
reference."""

from __future__ import annotations

import math

import torch

EPS = 1e-16

# IoU variant selector, the reference's integer iou_type codes.
IOU, GIOU, DIOU, CIOU = 0, 1, 2, 3


def cxcywh_to_xyxy(box: torch.Tensor) -> torch.Tensor:
    """[..., 4] centre format -> corner format."""
    cx, cy, w, h = box.unbind(-1)
    half_w, half_h = w * 0.5, h * 0.5
    return torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h], -1)


def xyxy_to_cxcywh(box: torch.Tensor) -> torch.Tensor:
    """[..., 4] corner format -> centre format."""
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def xywh_to_xyxy(box: torch.Tensor) -> torch.Tensor:
    """[..., 4] COCO [x, y, w, h] (top-left and size) -> corners."""
    x, y, w, h = box.unbind(-1)
    return torch.stack([x, y, x + w, y + h], -1)


def xyxy_to_xywh(box: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = box.unbind(-1)
    return torch.stack([x1, y1, x2 - x1, y2 - y1], -1)


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


def box_iou(box1: torch.Tensor, box2: torch.Tensor, iou_type: int = IOU,
            fmt: str = "cxcywh") -> torch.Tensor:
    """Broadcasting IoU / GIoU / DIoU / CIoU of [..., 4] boxes -> [...]:
    the union takes EPS on the first area, and CIoU's aspect-ratio trade-off
    ``alpha`` carries no gradient."""
    b1, b2 = (cxcywh_to_xyxy(box1), cxcywh_to_xyxy(box2)) if fmt == "cxcywh" else (box1, box2)
    b1_x1, b1_y1, b1_x2, b1_y2 = b1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = b2.unbind(-1)

    inter_w = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
    inter_h = (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    inter = inter_w * inter_h
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1
    union = (w1 * h1 + EPS) + w2 * h2 - inter
    iou = inter / union
    if iou_type == IOU:
        return iou

    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if iou_type == GIOU:
        c_area = cw * ch + EPS
        return iou - (c_area - union) / c_area

    c2 = cw ** 2 + ch ** 2 + EPS
    rho2 = (((b2_x1 + b2_x2) - (b1_x1 + b1_x2)) ** 2 / 4.0
            + ((b2_y1 + b2_y2) - (b1_y1 + b1_y2)) ** 2 / 4.0)
    if iou_type == DIOU:
        return iou - rho2 / c2

    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / (h2 + EPS)) - torch.atan(w1 / (h1 + EPS))) ** 2
    alpha = (v / (1.0 - iou + v + EPS)).detach()
    return iou - (rho2 / c2 + v * alpha)


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


def encode_boxes(reference_boxes: torch.Tensor, proposals: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Reference (GT) boxes [..., 4] encoded against proposals [..., 4], both
    xyxy, as weighted (dx, dy, dw, dh) deltas."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0]
    ex_h = proposals[..., 3] - proposals[..., 1]
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0]
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1]
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    dx = wx * (gt_cx - ex_cx) / ex_w
    dy = wy * (gt_cy - ex_cy) / ex_h
    dw = ww * torch.log(gt_w / ex_w)
    dh = wh * torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], -1)


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


class BoxCoder:
    """Stateless twin of the reference BoxCoder: ``encode_boxes`` and
    ``decode_boxes`` with fixed ``weights`` and ``bbox_xform_clip``."""

    def __init__(self, weights=(1.0, 1.0, 1.0, 1.0), bbox_xform_clip: float = BBOX_XFORM_CLIP):
        self.weights = tuple(float(w) for w in weights)
        self.bbox_xform_clip = bbox_xform_clip

    def encode(self, reference_boxes: torch.Tensor, proposals: torch.Tensor) -> torch.Tensor:
        return encode_boxes(reference_boxes, proposals, self.weights)

    def decode(self, rel_codes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        return decode_boxes(rel_codes, boxes, self.weights, self.bbox_xform_clip)
