"""RoIAlign and multiscale RoIAlign over FPN levels (port of the JAX
package's ``ops/roi_align.py``, torchvision MultiScaleRoIAlign semantics).

* aligned=False: box coordinates are scaled by the level's spatial scale
  with no half-pixel offset; each output bin averages ``sampling_ratio``²
  bilinear samples at y1 + (i + (k + 0.5) / s) * bin_h (and likewise in x);
  a sample outside [-1, H] x [-1, W] gives 0, the others clamp to the map.
* The level of a box comes from torchvision's LevelMapper
  (``assign_fpn_levels``).

The port keeps its maps NCHW (``channels_last`` memory in production) and
the JAX output layout ``[..., N, oh, ow, C]``. ``pool_multiscale`` sends a
CUDA batch to the hand-written kernel of ``kernels/roi_align.py`` and a CPU
batch to ``multiscale_roi_align_canvas``, the plain version, whose f32
arithmetic is that of the JAX canvas pooler (levels stacked for one gather
there, one flat buffer here; the samples and their weights are the same).
Under autograd it is differentiable with respect to the maps (not the
boxes): the backward is the kernel of ``kernels/roi_align_bwd.py`` for a
CUDA batch and the autograd of the plain version for a CPU batch.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def _infer_scale(feat_hw, image_size) -> float:
    """torchvision MultiScaleRoIAlign.infer_scale: 2^round(log2(feat / img))
    per axis, which must agree."""
    sy = 2.0 ** round(math.log2(feat_hw[0] / image_size[0]))  # half to even, as np.round
    sx = 2.0 ** round(math.log2(feat_hw[1] / image_size[1]))
    if sy != sx:
        raise ValueError(f"anisotropic FPN scale {sy} vs {sx} for feature {feat_hw} "
                         f"on image {image_size}")
    return sy


def assign_fpn_levels(boxes: torch.Tensor, num_levels: int, canonical_scale: int = 224,
                      canonical_level: int = 4, min_level: int = 2) -> torch.Tensor:
    """torchvision LevelMapper: boxes [..., 4] -> level index [...] int32 in
    [0, num_levels)."""
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp(min=0)
    # a tensor divisor: the GPU would multiply by the reciprocal of a number
    side = torch.sqrt(area) / torch.full_like(area, canonical_scale)
    k = torch.floor(canonical_level + torch.log2(side + 1e-6))
    return (k - min_level).clamp(0, num_levels - 1).to(torch.int32)


def axis_samples(lo: torch.Tensor, bin_size: torch.Tensor, out: int, s: int,
                 size: torch.Tensor):
    """The samples of each RoI along one axis: start ``lo`` [N], bin size
    [N] and the map's size [N] (float) -> (outside, i0, i1, frac), each
    [N, out, s]: sample k of bin i sits at lo + (i + (k + 0.5) / s) * bin;
    outside [-1, size] it counts 0, else it clamps to [0, size - 1] and
    interpolates between i0 = its floor and i1 = min(i0 + 1, size - 1) with
    weight ``frac`` on i1."""
    dev = lo.device
    i = torch.arange(out, dtype=torch.float32, device=dev)
    k = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    # Divisors are tensors: on the GPU PyTorch turns a division by a Python
    # number into a multiplication by its reciprocal, which rounds otherwise
    # than the division of the kernel and of the reference.
    k = k / torch.full_like(k, s)
    pos = lo[:, None, None] + (i[None, :, None] + k[None, None, :]) * bin_size[:, None, None]
    size = size[:, None, None]
    outside = (pos < -1.0) | (pos > size)
    c = torch.minimum(pos.clamp(min=0.0), size - 1)
    i0 = torch.floor(c)
    return outside, i0, torch.minimum(i0 + 1, size - 1), c - i0


def roi_samples(boxes: torch.Tensor, scale: torch.Tensor, height: torch.Tensor,
                width: torch.Tensor, output_size, sampling_ratio: int):
    """``axis_samples`` along y and x of boxes [N, 4] scaled by ``scale``
    [N] on maps of ``height`` x ``width`` [N]: bin = max(side, 1) / out."""
    oh, ow = output_size
    b = boxes * scale[:, None]
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    bin_w = (x2 - x1).clamp(min=1.0) / torch.full_like(x1, ow)
    bin_h = (y2 - y1).clamp(min=1.0) / torch.full_like(y1, oh)
    return (axis_samples(y1, bin_h, oh, sampling_ratio, height),
            axis_samples(x1, bin_w, ow, sampling_ratio, width))


def _pool_flat(flat: torch.Tensor, boxes: torch.Tensor, scale: torch.Tensor,
               height: torch.Tensor, width: torch.Tensor, offset: torch.Tensor,
               output_size, sampling_ratio: int) -> torch.Tensor:
    """Bilinear pooling from a flat [R, C] buffer: RoI n reads the map of
    ``height[n]`` x ``width[n]`` rows starting at ``offset[n]`` at
    ``scale[n]``. -> [N, oh, ow, C] float32."""
    (oy, y0, y1i, ly), (ox, x0, x1i, lx) = roi_samples(boxes, scale, height, width,
                                                       output_size, sampling_ratio)

    def ys(t):  # [N, oh, s] -> [N, oh, 1, s, 1]
        return t[:, :, None, :, None]

    def xs(t):  # [N, ow, s] -> [N, 1, ow, 1, s]
        return t[:, None, :, None, :]

    outside = ys(oy) | xs(ox)
    ly = ys(ly)[..., None]
    lx = xs(lx)[..., None]
    row = offset[:, None, None, None, None]
    w_i = width.long()[:, None, None, None, None]

    def at(yi, xi):
        return flat[row + ys(yi).long() * w_i + xs(xi).long()].float()

    out = ((1.0 - ly) * (1.0 - lx) * at(y0, x0) + (1.0 - ly) * lx * at(y0, x1i)
           + ly * (1.0 - lx) * at(y1i, x0) + ly * lx * at(y1i, x1i))
    out = torch.where(outside[..., None], 0.0, out)
    return out.mean(dim=(3, 4))


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size=(7, 7),
              spatial_scale: float = 1.0, sampling_ratio: int = 2) -> torch.Tensor:
    """One map [C, H, W], boxes [N, 4] xyxy in image coordinates ->
    [N, oh, ow, C] float32."""
    c, h, w = features.shape
    n = boxes.shape[0]
    full = boxes.new_full((n,), 1.0)
    return _pool_flat(features.permute(1, 2, 0).reshape(h * w, c), boxes,
                      full * spatial_scale, full * h, full * w,
                      torch.zeros(n, dtype=torch.long, device=boxes.device),
                      output_size, sampling_ratio)


def multiscale_roi_align_canvas(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                                image_size, output_size=(7, 7),
                                sampling_ratio: int = 2) -> torch.Tensor:
    """Multiscale RoIAlign of one image, the plain version: level maps
    [C, H_l, W_l], boxes [N, 4] -> [N, oh, ow, C] float32. Each box is
    pooled from its ``assign_fpn_levels`` level only."""
    dev = boxes.device
    c = features[0].shape[0]
    flat = torch.cat([f.permute(1, 2, 0).reshape(-1, c) for f in features])
    sizes = [f.shape[1:] for f in features]
    heights = torch.tensor([h for h, _ in sizes], dtype=torch.float32, device=dev)
    widths = torch.tensor([w for _, w in sizes], dtype=torch.float32, device=dev)
    offsets = torch.tensor(np.cumsum([0] + [h * w for h, w in sizes])[:-1],
                           dtype=torch.long, device=dev)
    scales = torch.tensor([_infer_scale(hw, image_size) for hw in sizes],
                          dtype=torch.float32, device=dev)
    levels = assign_fpn_levels(boxes, len(features)).long()
    return _pool_flat(flat, boxes, scales[levels], heights[levels], widths[levels],
                      offsets[levels], output_size, sampling_ratio)


class _PoolMultiscale(torch.autograd.Function):
    """The batched pooler with a backward for the maps; boxes get none."""

    @staticmethod
    def forward(ctx, boxes, image_size, output_size, sampling_ratio, *features):
        from object_detectors_tpu_torch.kernels import roi_align as roi_align_kernel

        ctx.save_for_backward(boxes)
        ctx.args = (tuple(tuple(f.shape) for f in features), image_size, output_size,
                    sampling_ratio, features[0].dtype)
        pool = (roi_align_kernel.multiscale_roi_align_cuda if boxes.is_cuda
                else roi_align_kernel.multiscale_roi_align_reference)
        return pool(features, boxes, image_size, output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad):
        from object_detectors_tpu_torch.kernels.roi_align_bwd import (
            multiscale_roi_align_backward,
        )

        (boxes,) = ctx.saved_tensors
        shapes, image_size, output_size, sampling_ratio, dtype = ctx.args
        grads = multiscale_roi_align_backward(grad, boxes, shapes, image_size, output_size,
                                              sampling_ratio, dtype)
        return (None, None, None, None, *grads)


def pool_multiscale(features: Sequence[torch.Tensor], boxes: torch.Tensor, image_size,
                    output_size=(7, 7), sampling_ratio: int = 2) -> torch.Tensor:
    """Batched pooler: level maps [B, C, H_l, W_l], boxes [B, N, 4] ->
    [B, N, oh, ow, C] in the maps' dtype. The kernel for CUDA tensors, the
    plain version (image by image) for CPU tensors; under autograd the
    backward of the maps is the backward kernel on the card."""
    if boxes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no RoIAlign for device {boxes.device}")
    return _PoolMultiscale.apply(boxes.detach(), tuple(image_size), tuple(output_size),
                                 sampling_ratio, *features)
