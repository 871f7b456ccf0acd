"""Mask R-CNN: Faster R-CNN plus a mask branch (port of the JAX package's
``models/mask_rcnn.py``, torchvision MaskRCNN semantics).

* ``MaskRCNNHeads``: 4 x (3x3 conv 256 + ReLU) on the 14x14 RoIAligned
  features; ``MaskRCNNPredictor``: a 2x2 / stride 2 transposed conv + ReLU
  and a 1x1 conv to per-class mask logits at 28x28.
* ``maskrcnn_loss``: the targets are the matched GT masks RoIAligned onto
  the sampled boxes at 28x28 (``project_masks_on_boxes``), BCE with logits
  at the GT class's channel, the mean over the positive (box, pixel) pairs.
* ``maskrcnn_inference``: the sigmoid of the predicted class's channel.
* ``paste_masks_in_image``: each 28x28 mask, padded by a pixel, resampled
  into its expanded box (truncated to integers, as the reference's int64
  cast) on the image canvas, as one static-shape inverse warp.

The mask branch pools with the same RoIAlign as the box branch (the
kernel on the card, forward and, in training, backward), at 14x14; it
keeps 300 detections, not Faster R-CNN's 100. Training reuses the box
sampler's matched GT index, not a fresh argmax that can disagree on ties.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.models.common import conv2d, conv_transpose2d
from object_detectors_tpu_torch.models.faster_rcnn import FasterRCNN, init_frcnn_
from object_detectors_tpu_torch.models.roi_heads import RoIHeadsConfig
from object_detectors_tpu_torch.models.rpn import RPNConfig
from object_detectors_tpu_torch.ops.roi_align import _pool_flat, pool_multiscale
from object_detectors_tpu_torch.parallel import mesh


class MaskRCNNHeads(nn.Module):
    def __init__(self, in_channels: int = 256, layers: int = 4, features: int = 256):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"mask_fcn{i + 1}", nn.Conv2d(in_channels if i == 0 else features,
                                                          features, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = F.relu(conv2d(x, getattr(self, f"mask_fcn{i + 1}")))
        return x


class MaskRCNNPredictor(nn.Module):
    def __init__(self, num_classes: int, in_channels: int = 256, features: int = 256):
        super().__init__()
        self.conv5_mask = nn.ConvTranspose2d(in_channels, features, 2, 2)
        self.mask_fcn_logits = nn.Conv2d(features, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(F.relu(conv_transpose2d(x, self.conv5_mask)), self.mask_fcn_logits)


def project_masks_on_boxes(gt_masks: torch.Tensor, boxes: torch.Tensor,
                           matched_idxs: torch.Tensor, m: int) -> torch.Tensor:
    """GT masks [B, M, H, W], boxes [B, S, 4], matched GT index [B, S] ->
    targets [B, S, m, m]: each box RoIAligned (sampling ratio 2, not
    aligned, as the JAX version) on its matched mask. The masks are read in
    place through a per-box offset, never gathered into [B, S, H, W]."""
    b, n_gt, h, w = gt_masks.shape
    s = boxes.shape[1]
    flat = gt_masks.reshape(-1, 1)
    image = torch.arange(b, device=boxes.device)[:, None]
    offset = ((image * n_gt + matched_idxs) * (h * w)).reshape(-1)
    ones = boxes.new_ones(b * s)
    out = _pool_flat(flat, boxes.reshape(-1, 4), ones, ones * h, ones * w, offset, (m, m), 2)
    return out.reshape(b, s, m, m)


def maskrcnn_loss(mask_logits: torch.Tensor, proposals: torch.Tensor, gt_masks: torch.Tensor,
                  gt_labels: torch.Tensor, matched_idxs: torch.Tensor,
                  pos_mask: torch.Tensor) -> torch.Tensor:
    """mask_logits [B, S, m, m, C], proposals [B, S, 4], GT masks [B, M, H, W]
    {0, 1}, labels [B, M], matched GT index [B, S], positive [B, S] -> the
    mean BCE over the positive (box, pixel) pairs."""
    b, s, m, _, _ = mask_logits.shape
    targets = project_masks_on_boxes(gt_masks.to(mask_logits.dtype), proposals, matched_idxs, m)
    lab = torch.gather(gt_labels.long(), 1, matched_idxs).clamp(min=0)
    at_label = mask_logits.gather(-1, lab[:, :, None, None, None].expand(b, s, m, m, 1))[..., 0]
    el = at_label.clamp(min=0) - at_label * targets + torch.log1p(torch.exp(-at_label.abs()))
    pos = pos_mask.to(mask_logits.dtype)
    # the global batch's count; each rank returns its share (parallel/mesh.py)
    count = mesh.global_sum((pos.sum(1) * (m * m)).sum())
    return mesh.rank_share((el * pos[:, :, None, None]).sum() / count.clamp(min=1.0))


def maskrcnn_inference(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[B, D, m, m, C] logits, labels [B, D] -> [B, D, m, m] probabilities."""
    b, d, m, _, _ = mask_logits.shape
    lab = labels.long().clamp(min=0)[:, :, None, None, None].expand(b, d, m, m, 1)
    return torch.sigmoid(mask_logits.gather(-1, lab)[..., 0])


def paste_masks_in_image(masks: torch.Tensor, boxes: torch.Tensor, image_size,
                         padding: int = 1) -> torch.Tensor:
    """[D, m, m] masks + [D, 4] xyxy boxes -> [D, H, W] pasted probabilities:
    for every image pixel, the bilinear sample (zero outside) of the padded
    mask at its place in the box expanded by the padding's scale and
    truncated to integers; only rows y0..y1 and columns x0..x1 of that box
    are pasted (roi_heads.py:415-536)."""
    d, m, _ = masks.shape
    im_h, im_w = image_size
    dev, dt = masks.device, masks.dtype
    scale = (m + 2 * padding) / m
    mp = m + 2 * padding
    padded = F.pad(masks, (padding, padding, padding, padding))
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    half_w = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    half_h = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x0, x1 = torch.trunc(cx - half_w), torch.trunc(cx + half_w)
    y0, y1 = torch.trunc(cy - half_h), torch.trunc(cy + half_h)
    w = (x1 - x0 + 1).clamp(min=1.0)
    h = (y1 - y0 + 1).clamp(min=1.0)
    ys = torch.arange(im_h, dtype=dt, device=dev)
    xs = torch.arange(im_w, dtype=dt, device=dev)
    my = ((ys[None, :] - y0[:, None] + 0.5) / h[:, None]) * mp - 0.5
    mx = ((xs[None, :] - x0[:, None] + 0.5) / w[:, None]) * mp - 0.5
    vy = (ys[None, :] >= y0[:, None]) & (ys[None, :] < y1[:, None] + 1)
    vx = (xs[None, :] >= x0[:, None]) & (xs[None, :] < x1[:, None] + 1)

    y0i, x0i = torch.floor(my), torch.floor(mx)
    ly, lx = (my - y0i)[:, :, None], (mx - x0i)[:, None, :]
    y0i, x0i = y0i.long(), x0i.long()
    flat = padded.reshape(d, mp * mp)

    def at(yi, xi):
        inside = (((yi >= 0) & (yi < mp))[:, :, None] & ((xi >= 0) & (xi < mp))[:, None, :])
        idx = yi.clamp(0, mp - 1)[:, :, None] * mp + xi.clamp(0, mp - 1)[:, None, :]
        v = flat.gather(1, idx.reshape(d, -1)).reshape(d, im_h, im_w)
        return torch.where(inside, v, 0.0)

    out = ((1 - ly) * ((1 - lx) * at(y0i, x0i) + lx * at(y0i, x0i + 1))
           + ly * ((1 - lx) * at(y0i + 1, x0i) + lx * at(y0i + 1, x0i + 1)))
    return out * (vy[:, :, None] & vx[:, None, :])


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    num_classes: int = 91
    rpn: RPNConfig = RPNConfig()
    # the reference's MaskRCNN keeps 300 detections (mask_rcnn.py:169)
    roi: RoIHeadsConfig = RoIHeadsConfig(detections_per_img=300)
    resnet_layers: tuple = (3, 4, 6, 3)
    mask_pool_size: tuple = (14, 14)
    backbone_fused: str = "off"  # fused eval bottlenecks (models/resnet.py)


class MaskRCNN(FasterRCNN):
    """Images [B, H, W, 3] (normalized) -> (boxes, scores, labels, valid,
    masks [B, D, 28, 28] probabilities at the predicted class); with
    ``train`` the loss dict of Faster R-CNN plus ``loss_mask``."""

    def __init__(self, cfg: MaskRCNNConfig = MaskRCNNConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype)
        self.mask_head = MaskRCNNHeads()
        self.mask_predictor = MaskRCNNPredictor(cfg.num_classes)

    def mask_logits(self, feats, boxes: torch.Tensor, image_size) -> torch.Tensor:
        """The mask branch on boxes [B, N, 4]: pooled at ``mask_pool_size``
        -> logits [B, N, 28, 28, C] f32."""
        pooled = pool_multiscale(feats[:4], boxes, image_size, self.cfg.mask_pool_size)
        b, n = pooled.shape[:2]
        x = pooled.to(self.dtype).flatten(0, 1).permute(0, 3, 1, 2)
        x = self.mask_predictor(self.mask_head(x))
        return x.permute(0, 2, 3, 1).reshape(b, n, *x.shape[2:], x.shape[1]).float()

    def forward(self, images: torch.Tensor, gt_boxes=None, gt_labels=None, gt_valid=None,
                gt_masks=None, train: bool = False, tfidf=None, class_weights=None,
                generator: torch.Generator | None = None, uniforms=None):
        """As ``FasterRCNN.forward``; ``gt_masks`` [B, M, H, W] {0, 1} at the
        image's resolution are the mask targets of ``train``."""
        self._check_train(train, gt_boxes, gt_labels, gt_valid, gt_masks)
        feats, objectness, deltas, level_sizes, size = self._trunk(images, lambda name: None)
        if train:
            losses, (s_boxes, s_pos, s_matched) = self._losses(
                feats, objectness, deltas, level_sizes, size, gt_boxes, gt_labels, gt_valid,
                tfidf, class_weights, generator, uniforms)
            loss_mask = maskrcnn_loss(self.mask_logits(feats, s_boxes, size), s_boxes, gt_masks,
                                      gt_labels, s_matched, s_pos)
            return {**losses, "loss_mask": loss_mask}
        boxes, scores, labels, valid = self._detect(feats, objectness, deltas, level_sizes, size,
                                                    tfidf, lambda name: None)
        masks = maskrcnn_inference(self.mask_logits(feats, boxes, size), labels)
        return boxes, scores, labels, valid, masks


def kaiming_normal_(weight: torch.Tensor, fan_in: int, g: torch.Generator):
    """Flax ``kaiming_normal``'s scale (the truncation aside): std
    sqrt(2 / fan_in)."""
    weight.copy_(torch.randn(weight.shape, generator=g) * (2.0 / fan_in) ** 0.5)


@torch.no_grad()
def init_maskrcnn_(model: MaskRCNN, seed: int = 0) -> MaskRCNN:
    """``init_frcnn_``, then the mask branch at Flax's kaiming-normal scale
    (the transposed conv's fan-in is in x kh x kw), zero biases."""
    init_frcnn_(model, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for m in [*model.mask_head.children(), *model.mask_predictor.children()]:
        kaiming_normal_(m.weight, m.weight.shape[0 if isinstance(m, nn.ConvTranspose2d) else 1]
                        * m.weight.shape[2] * m.weight.shape[3], g)
        m.bias.zero_()
    return model

