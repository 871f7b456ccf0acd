"""Anchor generation (copied from the JAX package's ``models/anchors.py``;
numpy only, torchvision AnchorGenerator semantics): zero-centered cell
anchors per level from sizes x aspect ratios (aspect = h/w, rounded),
shifted over the grid by integer strides and concatenated per level."""

from __future__ import annotations

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
