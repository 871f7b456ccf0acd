"""YOLOv3 criterion and decoder (port of the JAX package's
``models/yolo_criterion.py``).

Raw per-scale maps flatten to ``[B, P, 5+C]`` over priors ordered (h, w, a)
per scale, scales concatenated coarse -> fine. Grid priors are relative:
((gx+0.5)/W, (gy+0.5)/H, anchor_w/img, anchor_h/img), and each prior
carries its grid width.

Training (``yolo_loss``): each GT claims its best prior by ``iou_type``
(duplicates allowed: the loss is per GT); priors whose IoU with every valid
GT is below ``ignore_threshold`` and that no valid GT claimed form the
no-object mask. Losses: MSE on sigmoid-xy against the cell offsets clamped
to [1e-4, 0.9999], MSE on raw wh against log(gt / anchor + 1e-16), 1 - IoU
of the decoded boxes, focal-BCE objectness (matched priors against 1,
no-object priors against 0), and the CE / BCE / EQ class loss with the
tf-idf logit scale; the sum is normalized by the number of GTs. GT is
padded ``[B, M, ...]`` with a validity mask and every image is handled at
once. Above one process the counts (GTs, no-object priors, the minibatch
idf's) are those of the global batch and each rank returns its share of
the global loss and stats (``parallel/mesh.py:rank_share``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from object_detectors_tpu_torch.data.idf import minibatch_idf
from object_detectors_tpu_torch.ops import boxes as box_ops
from object_detectors_tpu_torch.ops import losses as L
from object_detectors_tpu_torch.ops.nms import gather_rows
from object_detectors_tpu_torch.parallel import mesh

# class_loss selector codes
CLASS_LOSS_BCE, CLASS_LOSS_CE, CLASS_LOSS_EQ = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class YoloLossConfig:
    """The JAX config: the head's loss settings and the dataset anchors."""

    num_classes: int = 80
    img_size: int = 416
    anchors: tuple = (
        ((116, 90), (156, 198), (373, 326)),
        ((30, 61), (62, 45), (59, 119)),
        ((10, 13), (16, 30), (33, 23)),
    )
    ignore_threshold: float = 0.5
    iou_type: int = box_ops.GIOU
    lambda_iou: float = 1.0
    lambda_xy: float = 2.5
    lambda_wh: float = 2.5
    lambda_conf: float = 1.0
    lambda_no_conf: float = 0.1
    lambda_cls: float = 1.0
    alpha: float = 0.5
    gamma: float = 1.0
    class_loss: int = CLASS_LOSS_CE
    reduction: str = "sum"
    # recompute the idf logit scale from the minibatch, optionally
    # Lp-normalized (p = tfidf_norm, 0 = off)
    tfidf_batch: bool = False
    tfidf_norm: int = 0


def make_priors(cfg: YoloLossConfig, grid_sizes: Sequence[int],
                device: str | torch.device = "cpu"):
    """(cxypwh [P, 4], grid_w [P]) for per-scale grid widths, e.g. (20, 40, 80)."""
    priors, inw = [], []
    for k, gs in enumerate(grid_sizes):
        a = torch.tensor(cfg.anchors[k], dtype=torch.float32, device=device)
        num_a = a.shape[0]
        r = torch.arange(gs, dtype=torch.float32, device=device)
        gy, gx = torch.meshgrid(r, r, indexing="ij")
        shape = (gs, gs, num_a)
        cx = ((gx + 0.5) / gs)[..., None].expand(shape)
        cy = ((gy + 0.5) / gs)[..., None].expand(shape)
        pw = (a[:, 0] / cfg.img_size)[None, None, :].expand(shape)
        ph = (a[:, 1] / cfg.img_size)[None, None, :].expand(shape)
        priors.append(torch.stack([cx, cy, pw, ph], -1).reshape(-1, 4))
        inw.append(torch.full((gs * gs * num_a,), float(gs), device=device))
    return torch.cat(priors, 0), torch.cat(inw, 0)


def flatten_raw_outputs(outputs, num_classes: int, anchors_per_scale: int):
    """NHWC raw maps [(B, H, W, A*(5+C)), ...] -> [B, P, 5+C]."""
    attrs = 5 + num_classes
    flat = [o.reshape(o.shape[0], o.shape[1] * o.shape[2] * anchors_per_scale, attrs)
            for o in outputs]
    return torch.cat(flat, 1)


def _decode(raw, priors, grid_w, img_size):
    """Raw regressions -> absolute pixel (xy, wh) centre format."""
    strides = (img_size / grid_w)[..., None]
    gw = grid_w[..., None]
    xy = (torch.sigmoid(raw[..., 0:2]) + priors[..., 0:2] * gw - 0.5) * strides
    wh = torch.exp(raw[..., 2:4]) * priors[..., 2:4] * gw * strides
    return xy, wh


def yolo_decode(raw_pred: torch.Tensor, priors: torch.Tensor, grid_w: torch.Tensor,
                cfg: YoloLossConfig, idf_logits: torch.Tensor | float = 1.0) -> torch.Tensor:
    """[B, P, 5+C] raw -> [B, P, 5+C] with absolute pixel cxcywh, sigmoid
    objectness and the class probabilities of the tf-idf scaled logits:
    softmax for a CE-trained head, sigmoid otherwise."""
    xy, wh = _decode(raw_pred, priors[None], grid_w[None], cfg.img_size)
    conf = torch.sigmoid(raw_pred[..., 4:5])
    logits = raw_pred[..., 5:] * idf_logits
    if cfg.class_loss == CLASS_LOSS_CE:
        cls = torch.softmax(logits, dim=-1)
    else:
        cls = torch.sigmoid(logits)
    return torch.cat([xy, wh, conf, cls], -1)


def _per_image_targets(gt_boxes, gt_valid, priors, grid_w, cfg: YoloLossConfig):
    """The targets of every image at once: gt_boxes [B, M, 4] relative
    cxcywh, gt_valid [B, M] -> best prior [B, M], targets (gx, gy, gw, gh)
    [B, M, 4], no-object mask [B, P] bool.

    A prior is claimed when a valid GT has it as its best. (The JAX
    function's scatter lets a padded GT, whose best prior is 0 as its IoUs
    are zeroed, write False over a valid GT's claim of prior 0; the port
    keeps the valid claim.)"""
    iou = box_ops.box_iou(gt_boxes[:, :, None, :], priors[None, None], iou_type=cfg.iou_type)
    iou = torch.where(gt_valid[..., None], iou, 0.0)  # [B, M, P]
    best = iou.argmax(-1)  # the first of equal maxima, as jnp.argmax

    matched_prior = priors[best]  # [B, M, 4]
    in_wh = grid_w[best]          # [B, M]
    gxy_abs = gt_boxes[..., 0:2] * in_wh[..., None]
    gxy = (gxy_abs - torch.floor(gxy_abs)).clamp(0.0001, 0.9999)
    gwh = torch.log(gt_boxes[..., 2:4] / matched_prior[..., 2:4] + 1e-16)
    tgt = torch.cat([gxy, gwh], -1)

    below = torch.where(gt_valid[..., None], iou < cfg.ignore_threshold, True)
    claimed = torch.zeros(iou.shape[0], iou.shape[2], dtype=torch.int32, device=iou.device)
    claimed.scatter_add_(1, best, gt_valid.to(torch.int32))
    noobj = below.all(1) & (claimed == 0)
    return best, tgt, noobj


def yolo_loss(raw_pred: torch.Tensor, priors: torch.Tensor, grid_w: torch.Tensor,
              gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_valid: torch.Tensor,
              cfg: YoloLossConfig, class_weights: torch.Tensor | None = None,
              idf_logits: torch.Tensor | float = 1.0,
              eq_rare_mask: torch.Tensor | None = None):
    """Training criterion: raw_pred [B, P, 5+C] float32, GT padded (boxes
    [B, M, 4] relative cxcywh, labels [B, M], valid [B, M] bool);
    ``class_weights`` [C] the CE weight or BCE pos_weight, ``idf_logits`` a
    scalar or [C] logit scale, ``eq_rare_mask`` [C] for the EQ loss.

    Returns (loss, sub_losses [6]: xy, wh, iou, pos_conf, neg_conf, cls;
    stats [5], without gradient: avg IoU, pos conf, no-obj conf, prob at the
    GT class, mean prob at the other classes). Above one process the GTs
    and the no-object priors are counted over the global batch, and the
    loss, sub-losses and stats are this rank's share of the global ones."""
    b, m = gt_boxes.shape[:2]
    vmask = gt_valid.to(raw_pred.dtype)

    best, tgt, noobj = _per_image_targets(gt_boxes, gt_valid, priors, grid_w, cfg)
    # the counts of the global batch, in one all-reduce above one process
    num_gt, nm_total = mesh.global_sum(torch.stack([gt_valid.sum(), noobj.sum()])).clamp(
        min=1).to(raw_pred.dtype).unbind()
    final = gather_rows(raw_pred, best)  # [B, M, 5+C]
    matched_prior = priors[best]
    matched_gw = grid_w[best]

    # decoded prediction and GT boxes in absolute pixels
    pxy, pwh = _decode(final, matched_prior, matched_gw, cfg.img_size)
    stride = (cfg.img_size / matched_gw)[..., None]
    gxy = (tgt[..., 0:2] + matched_prior[..., 0:2] * matched_gw[..., None] - 0.5) * stride
    gwh = torch.exp(tgt[..., 2:4]) * matched_prior[..., 2:4] * matched_gw[..., None] * stride
    iou = box_ops.box_iou(torch.cat([pxy, pwh], -1), torch.cat([gxy, gwh], -1),
                          iou_type=cfg.iou_type)  # [B, M]

    loss_xy = cfg.lambda_xy * ((torch.sigmoid(final[..., 0:2]) - tgt[..., 0:2]) ** 2
                               * vmask[..., None]).sum()
    loss_wh = cfg.lambda_wh * ((final[..., 2:4] - tgt[..., 2:4]) ** 2 * vmask[..., None]).sum()
    loss_iou = cfg.lambda_iou * ((1.0 - iou) * vmask).sum()
    pos_conf_loss = cfg.lambda_conf * (L.focal_loss(
        final[..., 4], torch.ones_like(final[..., 4]), cfg.gamma, cfg.alpha) * vmask).sum()
    nmask = noobj.to(raw_pred.dtype)
    neg_conf_loss = cfg.lambda_no_conf * (L.focal_loss(
        raw_pred[..., 4], torch.zeros_like(raw_pred[..., 4]), cfg.gamma, cfg.alpha)
        * nmask).sum()

    if cfg.tfidf_batch:
        idf_logits = minibatch_idf(gt_labels, gt_valid, cfg.num_classes)
        if cfg.tfidf_norm:
            idf_logits = idf_logits / torch.linalg.vector_norm(idf_logits, ord=cfg.tfidf_norm)
    cls_logits = final[..., 5:] * idf_logits  # [B, M, C]
    labels_oh = L.one_hot(gt_labels, cfg.num_classes, raw_pred.dtype)
    if cfg.class_loss == CLASS_LOSS_CE:
        nll = L.softmax_cross_entropy(cls_logits, gt_labels, class_weights)
        class_loss = cfg.lambda_cls * (nll * vmask).sum()
    else:
        if cfg.class_loss == CLASS_LOSS_EQ:
            rare = (eq_rare_mask if eq_rare_mask is not None
                    else torch.zeros(cfg.num_classes, dtype=raw_pred.dtype,
                                     device=raw_pred.device))
            per_el = L.eq_loss(cls_logits.reshape(-1, cfg.num_classes),
                               labels_oh.reshape(-1, cfg.num_classes), rare, cfg.gamma,
                               cfg.alpha, class_weights).reshape(b, m, cfg.num_classes)
        else:  # BCE with pos_weight
            per_el = L.sigmoid_binary_cross_entropy(cls_logits, labels_oh, class_weights)
        class_loss = cfg.lambda_cls * (per_el * vmask[..., None]).sum()

    loss = loss_xy + loss_wh + loss_iou + pos_conf_loss + neg_conf_loss + class_loss
    sub = torch.stack([loss_xy, loss_wh, loss_iou, pos_conf_loss, neg_conf_loss, class_loss])
    if cfg.reduction == "sum":
        loss = loss / num_gt
        sub = sub / num_gt
    loss, sub = mesh.rank_share(loss), mesh.rank_share(sub)

    with torch.no_grad():
        pred_conf = torch.sigmoid(final[..., 4])
        if cfg.class_loss == CLASS_LOSS_CE:
            pred_cls = torch.softmax(final[..., 5:], -1)
        else:
            pred_cls = torch.sigmoid(final[..., 5:])
        neg_count = (num_gt * (cfg.num_classes - 1)).clamp(min=1.0)
        stats = torch.stack([
            (iou * vmask).sum() / num_gt,
            (pred_conf * vmask).sum() / num_gt,
            (torch.sigmoid(raw_pred[..., 4]) * nmask).sum() / nm_total,
            ((pred_cls * labels_oh).sum(-1) * vmask).sum() / num_gt,
            (pred_cls * (1.0 - labels_oh) * vmask[..., None]).sum() / neg_count,
        ])
    return loss, sub, mesh.rank_share(stats)
