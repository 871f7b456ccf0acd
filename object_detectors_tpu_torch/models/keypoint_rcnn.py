"""Keypoint R-CNN: Faster R-CNN plus a keypoint branch (port of the JAX
package's ``models/keypoint_rcnn.py``, torchvision KeypointRCNN semantics,
2 classes).

* ``KeypointRCNNHeads``: 8 x (3x3 conv 512 + ReLU) on the 14x14 RoIAligned
  features; ``KeypointRCNNPredictor``: a 4x4 / stride 2 transposed conv and
  a 2x bilinear upscale -> K heatmap logits at 56x56.
* ``keypoints_to_heatmap``: each keypoint's target cell in its box's
  heatmap, valid where visible and inside the box.
* ``keypointrcnn_loss``: softmax cross-entropy over the flattened heatmap
  at each valid keypoint's cell, the mean over the valid ones.
* ``heatmaps_to_keypoints``: the JAX package's fixed 4x bicubic refinement
  (``jax.image.resize``'s Keys cubic, a = -0.5) and argmax.
* ``heatmaps_to_keypoints_exact``, the model's decode: each heatmap
  resized (PyTorch's bicubic, a = -0.75) to its RoI's own ceil(w) x ceil(h)
  pixel grid, up to ``max_roi_size`` a side, as two products against
  per-RoI sampling matrices, then the row-major argmax. The detections go
  through in chunks, with TF32 off for the products.

Every division by a size divides two tensors: on the GPU PyTorch turns a
division by a Python number into a multiplication by its rounded
reciprocal, which moves a cell index that floors the result.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.kernels.preprocess import bicubic_rows
from object_detectors_tpu_torch.models.common import conv2d, conv_transpose2d, tf32_off
from object_detectors_tpu_torch.models.faster_rcnn import FasterRCNN, init_frcnn_
from object_detectors_tpu_torch.models.mask_rcnn import kaiming_normal_
from object_detectors_tpu_torch.models.roi_heads import RoIHeadsConfig
from object_detectors_tpu_torch.models.rpn import RPNConfig
from object_detectors_tpu_torch.ops.nms import gather_rows
from object_detectors_tpu_torch.ops.roi_align import pool_multiscale
from object_detectors_tpu_torch.parallel import mesh

EXACT_CHUNK = 32  # detections a chunk of heatmaps_to_keypoints_exact: [32, K, 512, 512] f32


class KeypointRCNNHeads(nn.Module):
    def __init__(self, in_channels: int = 256, layers: int = 8, features: int = 512):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"kps_fcn{i + 1}", nn.Conv2d(in_channels if i == 0 else features,
                                                         features, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = F.relu(conv2d(x, getattr(self, f"kps_fcn{i + 1}")))
        return x


class KeypointRCNNPredictor(nn.Module):
    def __init__(self, in_channels: int = 512, num_keypoints: int = 17):
        super().__init__()
        # Flax's 4x4 / stride 2 "SAME" transposed conv: padding 1 (the
        # converter flips the kernel, which Flax does not)
        self.kps_score_lowres = nn.ConvTranspose2d(in_channels, num_keypoints, 4, 2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_transpose2d(x, self.kps_score_lowres)
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def keypoints_to_heatmap(keypoints: torch.Tensor, boxes: torch.Tensor, heatmap_size: int):
    """Keypoints [..., S, K, 3] (x, y, visibility) and boxes [..., S, 4] ->
    (target cell [..., S, K] int64, 0 where not valid; valid [..., S, K]).
    A point on the box's far edge maps to the last cell."""
    x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
    w = (boxes[..., 2:3] - x1).clamp(min=1e-6)
    h = (boxes[..., 3:4] - y1).clamp(min=1e-6)
    size = torch.full_like(w, heatmap_size)
    x = (keypoints[..., 0] - x1) * (size / w)
    y = (keypoints[..., 1] - y1) * (size / h)
    x_int, y_int = torch.floor(x).long(), torch.floor(y).long()
    x_int = torch.where(x_int == heatmap_size, heatmap_size - 1, x_int)
    y_int = torch.where(y_int == heatmap_size, heatmap_size - 1, y_int)
    valid = ((keypoints[..., 2] > 0) & (x_int >= 0) & (y_int >= 0)
             & (x_int < heatmap_size) & (y_int < heatmap_size))
    cell = (y_int.clamp(0, heatmap_size - 1) * heatmap_size
            + x_int.clamp(0, heatmap_size - 1))
    return cell * valid, valid


def keypointrcnn_loss(kp_logits: torch.Tensor, proposals: torch.Tensor,
                      gt_keypoints: torch.Tensor, matched_idxs: torch.Tensor,
                      pos_mask: torch.Tensor) -> torch.Tensor:
    """kp_logits [B, S, H, H, K], proposals [B, S, 4], GT keypoints
    [B, M, K, 3], matched GT index [B, S], positive [B, S] -> the mean
    cross-entropy over the valid keypoints of the positives (0 without
    any)."""
    b, s, hm, _, k = kp_logits.shape
    cell, valid = keypoints_to_heatmap(gather_rows(gt_keypoints, matched_idxs), proposals, hm)
    valid = valid & pos_mask[..., None]
    logp = torch.log_softmax(kp_logits.reshape(b, s, hm * hm, k).transpose(2, 3), -1)
    nll = -logp.gather(-1, cell[..., None])[..., 0]
    # the global batch's count; each rank returns its share (parallel/mesh.py)
    count = mesh.global_sum(valid.sum()).clamp(min=1).to(nll.dtype)
    return mesh.rank_share((nll * valid).sum() / count)


@functools.lru_cache(maxsize=None)
def _jax_bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of ``jax.image.resize(..., "bicubic")`` along
    one axis when upsampling: Keys cubic (a = -0.5) at (i + 0.5) * n_in /
    n_out - 0.5, renormalized over the taps inside the input."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    w = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x
                 + np.float32(2.0), w)
    w = np.where(x >= 2.0, np.float32(0.0), w).astype(np.float32)
    total = w.sum(0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).T.astype(np.float32)


def heatmaps_to_keypoints(kp_logits: torch.Tensor, boxes: torch.Tensor, upsample: int = 4):
    """The JAX package's fixed-grid decode: [B, D, H, H, K] logits and boxes
    [B, D, 4] -> (keypoints [B, D, K, 3] (x, y, 1), scores [B, D, K]). One
    bicubic upsample to a ``upsample`` x finer grid, its argmax mapped to
    (i + 0.5) / grid in the box; the score is the coarse grid's softmax
    probability at the refined peak's cell."""
    b, d, hm, _, k = kp_logits.shape
    logits = kp_logits.float()
    g = hm * upsample
    if upsample > 1:
        wm = torch.from_numpy(_jax_bicubic_matrix(hm, g)).to(logits.device)
        up = torch.einsum("bdhwk,yh,xw->bdyxk", logits, wm, wm)
    else:
        up = logits
    idx = up.reshape(b, d, g * g, k).argmax(2)  # [B, D, K]
    probs = torch.softmax(logits.reshape(b, d, hm * hm, k), 2)
    cidx = ((idx // g) // upsample) * hm + (idx % g) // upsample
    scores = probs.gather(2, cidx[:, :, None, :])[:, :, 0, :]
    grid = torch.full((), g, dtype=torch.float32, device=logits.device)
    yy = (idx // g).float() + 0.5
    xx = (idx % g).float() + 0.5
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-6)[..., None]
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-6)[..., None]
    x = boxes[..., 0][..., None] + xx / grid * w
    y = boxes[..., 1][..., None] + yy / grid * h
    return torch.stack([x, y, torch.ones_like(x)], -1), scores


def _exact_chunk(logits: torch.Tensor, ky: torch.Tensor, kx: torch.Tensor, hc: torch.Tensor,
                 wc: torch.Tensor):
    """The peaks of [D, H, H, K] logits resampled through ky [D, n, H] and
    kx [D, n, H] on the valid hc x wc prefix of each n x n grid -> (flat
    peak index [D, K], its interpolated logit [D, K])."""
    d, _, _, k = logits.shape
    n = ky.shape[1]
    maps = logits.float().permute(0, 3, 1, 2)  # [D, K, H, H]
    s = torch.einsum("dkyw,dxw->dkyx", torch.einsum("dyh,dkhw->dkyw", ky, maps), kx)
    i = torch.arange(n, dtype=torch.float32, device=logits.device)
    valid = (i[None, :, None] < hc[:, None, None]) & (i[None, None, :] < wc[:, None, None])
    flat = torch.where(valid[:, None], s, float("-inf")).reshape(d, k, n * n)
    pos = flat.argmax(-1)  # the first of equal maxima
    return pos, flat.gather(-1, pos[..., None])[..., 0]


def heatmaps_to_keypoints_exact(kp_logits: torch.Tensor, boxes: torch.Tensor,
                                max_roi_size: int = 512):
    """The reference decode: [B, D, H, H, K] logits and boxes [B, D, 4] ->
    (keypoints [B, D, K, 3] (x, y, 1), scores [B, D, K] the interpolated
    logits at the peaks). Exact for RoIs up to ``max_roi_size`` px a side;
    the sampling matrices of all detections at once, the products and peaks
    EXACT_CHUNK detections at a time."""
    chunk = EXACT_CHUNK
    b, d, hm, _, k = kp_logits.shape
    n = max_roi_size
    logits = kp_logits.reshape(b * d, hm, hm, k)
    flat_boxes = boxes.reshape(b * d, 4).float()
    x1, y1 = flat_boxes[:, 0], flat_boxes[:, 1]
    w = (flat_boxes[:, 2] - x1).clamp(min=1.0)
    h = (flat_boxes[:, 3] - y1).clamp(min=1.0)
    cap = torch.full_like(w, n)
    wc, hc = torch.minimum(torch.ceil(w), cap), torch.minimum(torch.ceil(h), cap)
    n_in = torch.full_like(w, hm)
    ky = bicubic_rows(n_in / hc, n_in, hm, n)  # [B * D, n, hm]
    kx = bicubic_rows(n_in / wc, n_in, hm, n)
    with tf32_off():
        parts = [_exact_chunk(logits[i:i + chunk], ky[i:i + chunk], kx[i:i + chunk],
                              hc[i:i + chunk], wc[i:i + chunk])
                 for i in range(0, b * d, chunk)]
    pos = torch.cat([p[0] for p in parts])
    scores = torch.cat([p[1] for p in parts])
    x = ((pos % n).float() + 0.5) * (w / wc)[:, None] + x1[:, None]
    y = ((pos // n).float() + 0.5) * (h / hc)[:, None] + y1[:, None]
    kps = torch.stack([x, y, torch.ones_like(x)], -1)
    return kps.reshape(b, d, k, 3), scores.reshape(b, d, k)


@dataclasses.dataclass(frozen=True)
class KeypointRCNNConfig:
    num_classes: int = 2           # person vs background (coco_kp)
    num_keypoints: int = 17
    rpn: RPNConfig = RPNConfig()
    roi: RoIHeadsConfig = RoIHeadsConfig(num_classes=2)
    resnet_layers: tuple = (3, 4, 6, 3)
    keypoint_pool_size: tuple = (14, 14)
    kp_head_layers: int = 8
    kp_head_features: int = 512
    backbone_fused: str = "off"  # fused eval bottlenecks (models/resnet.py)


class KeypointRCNN(FasterRCNN):
    """Images [B, H, W, 3] (normalized) -> (boxes, scores, labels, valid,
    keypoints [B, D, K, 3], kp_scores [B, D, K]); with ``train`` the loss
    dict of Faster R-CNN plus ``loss_keypoint``."""

    def __init__(self, cfg: KeypointRCNNConfig = KeypointRCNNConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype)
        self.kp_head = KeypointRCNNHeads(256, cfg.kp_head_layers, cfg.kp_head_features)
        self.kp_predictor = KeypointRCNNPredictor(cfg.kp_head_features, cfg.num_keypoints)

    def keypoint_logits(self, feats, boxes: torch.Tensor, image_size) -> torch.Tensor:
        """The keypoint branch on boxes [B, N, 4]: pooled at
        ``keypoint_pool_size`` -> heatmap logits [B, N, 56, 56, K] f32."""
        pooled = pool_multiscale(feats[:4], boxes, image_size, self.cfg.keypoint_pool_size)
        b, n = pooled.shape[:2]
        x = pooled.to(self.dtype).flatten(0, 1).permute(0, 3, 1, 2)
        x = self.kp_predictor(self.kp_head(x))
        return x.permute(0, 2, 3, 1).reshape(b, n, *x.shape[2:], x.shape[1]).float()

    def forward(self, images: torch.Tensor, gt_boxes=None, gt_labels=None, gt_valid=None,
                gt_keypoints=None, train: bool = False, tfidf=None, class_weights=None,
                generator: torch.Generator | None = None, uniforms=None):
        """As ``FasterRCNN.forward``; ``gt_keypoints`` [B, M, K, 3] absolute
        (x, y, visibility) for each GT box are the targets of ``train``."""
        self._check_train(train, gt_boxes, gt_labels, gt_valid, gt_keypoints)
        feats, objectness, deltas, level_sizes, size = self._trunk(images, lambda name: None)
        if train:
            losses, (s_boxes, s_pos, s_matched) = self._losses(
                feats, objectness, deltas, level_sizes, size, gt_boxes, gt_labels, gt_valid,
                tfidf, class_weights, generator, uniforms)
            loss = keypointrcnn_loss(self.keypoint_logits(feats, s_boxes, size), s_boxes,
                                     gt_keypoints, s_matched, s_pos)
            return {**losses, "loss_keypoint": loss}
        boxes, scores, labels, valid = self._detect(feats, objectness, deltas, level_sizes, size,
                                                    tfidf, lambda name: None)
        keypoints, kp_scores = heatmaps_to_keypoints_exact(
            self.keypoint_logits(feats, boxes, size), boxes)
        return boxes, scores, labels, valid, keypoints, kp_scores


@torch.no_grad()
def init_kprcnn_(model: KeypointRCNN, seed: int = 0) -> KeypointRCNN:
    """``init_frcnn_``, then the keypoint head at Flax's kaiming-normal scale
    and the transposed conv at its LeCun-normal one (fan-in in x 4 x 4),
    zero biases."""
    init_frcnn_(model, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.kp_head.children():
        kaiming_normal_(m.weight, m.weight[0].numel(), g)
        m.bias.zero_()
    t = model.kp_predictor.kps_score_lowres
    t.weight.copy_(torch.randn(t.weight.shape, generator=g) * (t.weight.shape[0] * 16) ** -0.5)
    t.bias.zero_()
    return model
