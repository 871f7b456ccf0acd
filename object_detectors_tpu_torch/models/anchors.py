"""Anchor generation (copied from the JAX package's ``models/anchors.py``;
numpy only, torchvision AnchorGenerator semantics): zero-centered cell
anchors per level from sizes x aspect ratios (aspect = h/w, rounded),
shifted over the grid by integer strides and concatenated per level; and
SSD's default boxes (torchvision DefaultBoxGenerator)."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def cell_anchors(scales: Sequence[float],
                 aspect_ratios: Sequence[float]) -> np.ndarray:
    """Zero-centered [len(ar)*len(scales), 4] xyxy anchors, rounded
    (anchor_utils.py:60-72). aspect ratio = h/w."""
    scales = np.asarray(scales, np.float32)
    ar = np.asarray(aspect_ratios, np.float32)
    h_ratios = np.sqrt(ar)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
    return np.round(np.stack([-ws, -hs, ws, hs], axis=1) / 2.0)


def grid_anchors(
    image_size: tuple[int, int],
    grid_sizes: Sequence[tuple[int, int]],
    sizes: Sequence[Sequence[float]],
    aspect_ratios: Sequence[Sequence[float]],
) -> np.ndarray:
    """All anchors for one resolution, concatenated over levels:
    [sum_l H_l*W_l*A_l, 4] xyxy pixels (anchor_utils.py:98-159).

    Grid shift order is (y, x) row-major with per-cell anchors innermost —
    matching the reference's meshgrid + reshape.
    """
    out = []
    for (gh, gw), s, ar in zip(grid_sizes, sizes, aspect_ratios):
        base = cell_anchors(s, ar)  # [A, 4]
        stride_h = image_size[0] // gh
        stride_w = image_size[1] // gw
        shifts_x = np.arange(gw, dtype=np.float32) * stride_w
        shifts_y = np.arange(gh, dtype=np.float32) * stride_h
        sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
        shifts = np.stack(
            [sx.reshape(-1), sy.reshape(-1), sx.reshape(-1), sy.reshape(-1)],
            axis=1)
        out.append(
            (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4))
    return np.concatenate(out, axis=0).astype(np.float32)


def fpn_grid_sizes(image_size: tuple[int, int],
                   num_levels: int = 5) -> list[tuple[int, int]]:
    """Per-level feature (H_l, W_l) for the ResNet-FPN pyramid starting at
    stride 8 (RetinaNet P3..P7), as the conv chain computes them: every
    stride-2 op is a halving that rounds up, out = ceil(in / 2) (not
    ``image_size // stride``: at 320 the P7 map is 3x3)."""
    h, w = image_size
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
    out = []
    for _ in range(num_levels):
        out.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return out


def rpn_anchor_config():
    """Faster/Mask R-CNN FPN RPN: one size per level x 3 aspect ratios
    (frcnn.py:302-320)."""
    sizes = ((32,), (64,), (128,), (256,), (512,))
    aspect_ratios = ((0.5, 1.0, 2.0),) * 5
    return sizes, aspect_ratios


def retinanet_anchor_config():
    """RetinaNet: 3 octave scales per level x 3 aspect ratios
    (retinanet.py:629-633)."""
    sizes = tuple(
        tuple(int(x * 2 ** (i / 3)) for i in range(3))
        for x in [32, 64, 128, 256, 512]
    )
    aspect_ratios = ((0.5, 1.0, 2.0),) * 5
    return sizes, aspect_ratios


# ssd300_vgg16's default boxes (torchvision ssd300_vgg16's DefaultBoxGenerator)
SSD_ASPECT_RATIOS = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
SSD_SCALES = (0.07, 0.15, 0.33, 0.51, 0.69, 0.87, 1.05)
SSD_STEPS = (8, 16, 32, 64, 100, 300)


def ssd_default_boxes(image_size: tuple[int, int],
                      grid_sizes: Sequence[tuple[int, int]]) -> np.ndarray:
    """ssd300_vgg16's default boxes in xyxy pixels [sum_l H*W*A_l, 4]
    (anchor_utils.py:160-278), the (w, h) pairs clipped to [0, 1]."""
    boxes = []
    for k, (gh, gw) in enumerate(grid_sizes):
        s_k = SSD_SCALES[k]
        s_prime = math.sqrt(SSD_SCALES[k] * SSD_SCALES[k + 1])
        pairs = [[s_k, s_k], [s_prime, s_prime]]
        for ar in SSD_ASPECT_RATIOS[k]:
            sq = math.sqrt(ar)
            pairs.extend([[s_k * sq, s_k / sq], [s_k / sq, s_k * sq]])
        wh = np.clip(np.asarray(pairs, np.float32), 0, 1)
        x_f = image_size[1] / SSD_STEPS[k]
        y_f = image_size[0] / SSD_STEPS[k]
        shifts_x = (np.arange(gw, dtype=np.float32) + 0.5) / x_f
        shifts_y = (np.arange(gh, dtype=np.float32) + 0.5) / y_f
        sy, sx = np.meshgrid(shifts_y, shifts_x, indexing="ij")
        centers = np.stack([sx.reshape(-1), sy.reshape(-1)], 1)  # [HW, 2]
        a = wh.shape[0]
        cxy = np.repeat(centers, a, axis=0)          # [HW*A, 2]
        whr = np.tile(wh, (gh * gw, 1))              # [HW*A, 2]
        cxywh = np.concatenate([cxy, whr], axis=1)
        xyxy = np.concatenate([cxywh[:, :2] - 0.5 * cxywh[:, 2:],
                               cxywh[:, :2] + 0.5 * cxywh[:, 2:]], axis=1)
        xyxy[:, 0::2] *= image_size[1]
        xyxy[:, 1::2] *= image_size[0]
        boxes.append(xyxy)
    return np.concatenate(boxes, axis=0).astype(np.float32)
