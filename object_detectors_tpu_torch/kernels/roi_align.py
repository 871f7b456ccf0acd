"""Multiscale RoIAlign forward over FPN levels (MultiScaleRoIAlign,
aligned=False): level maps [B, C, H_l, W_l] and boxes [B, N, 4] ->
[B, N, oh, ow, C].

Port of the four RoIAlign kernels of
``object_detectors_tpu/kernels/roi_align_pallas.py`` (the bands_grouped
default, bands, tiled and the per-RoI window kernel), which compute this one
function. ``multiscale_roi_align_cuda`` launches the hand-written kernel in
``csrc/roi_align.cu`` (or raises); ``multiscale_roi_align_reference`` is the
plain version, ``ops/roi_align.py:multiscale_roi_align_canvas`` image by
image, which takes each box's level from ``assign_fpn_levels``; the kernel
computes the same level in the same f32 operations. ``staged_rois``
repeats on the host the rule by which the kernel stages a RoI's footprint
in shared memory; ``backward_routes`` the rule by which the backward kernel
(``kernels/roi_align_bwd.py``) sends a RoI's pixel sums to L2.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from object_detectors_tpu_torch.kernels._build import load_library
from object_detectors_tpu_torch.ops.roi_align import (
    _infer_scale, assign_fpn_levels, multiscale_roi_align_canvas, roi_samples,
)

MAX_LEVELS = 4
# kStagePixels of csrc/roi_align.cu: the largest footprint (rows x columns)
# the kernel stages in shared memory
STAGE_PIXELS = 272

# Kernel launches so far; a run sets it to 0 and reads it to show that a
# path went through the kernel.
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def multiscale_roi_align_reference(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                                   image_size, output_size=(7, 7),
                                   sampling_ratio: int = 2) -> torch.Tensor:
    """Plain PyTorch version, one image at a time (the per-sample tensors of
    a whole batch would not fit): [B, N, oh, ow, C] in the maps' dtype."""
    out = [multiscale_roi_align_canvas([f[i] for f in features], boxes[i], image_size,
                                       output_size, sampling_ratio)
           for i in range(boxes.shape[0])]
    oh, ow = output_size
    if not out:
        return boxes.new_empty((0, boxes.shape[1], oh, ow, features[0].shape[1]),
                               dtype=features[0].dtype)
    return torch.stack(out).to(features[0].dtype)


def _distinct(outside: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor) -> torch.Tensor:
    """Samples [N, out, s] -> [N, 2 out s]: the distinct values of i0 and i1
    over the samples not outside, ascending, padded with -1."""
    inside = ~outside.flatten(1)
    v = torch.cat([i0.flatten(1), i1.flatten(1)], 1)
    v = torch.where(torch.cat([inside, inside], 1), v, float("inf")).sort(1).values
    new = torch.ones_like(v, dtype=torch.bool)
    new[:, 1:] = v[:, 1:] != v[:, :-1]
    v = torch.where(new & torch.isfinite(v), v, float("inf")).sort(1).values
    return torch.where(torch.isfinite(v), v, -1.0).long()


def staging_window(features: Sequence[torch.Tensor], boxes: torch.Tensor, image_size,
                   output_size=(7, 7), sampling_ratio: int = 2):
    """The footprint of each RoI as the kernel stages it: the distinct rows
    and columns of its level map that the corners of its samples inside
    [-1, H] x [-1, W] touch. Level maps [B, C, H_l, W_l] (only their
    shapes are read), boxes [B, N, 4] ->
    (rows [B, N, 2 oh s], cols [B, N, 2 ow s]) int64, each RoI's indices
    ascending, padded with -1. The kernel stages a RoI whose rows x columns
    are at most ``STAGE_PIXELS`` and reads the corners of the others
    directly."""
    b, n = boxes.shape[:2]
    (oy, y0, y1), (ox, x0, x1) = _taps(features, boxes, image_size, output_size,
                                       sampling_ratio)
    oh, ow = output_size
    return (_distinct(oy, y0, y1).view(b, n, 2 * oh * sampling_ratio),
            _distinct(ox, x0, x1).view(b, n, 2 * ow * sampling_ratio))


def _taps(features, boxes, image_size, output_size, sampling_ratio):
    """Each RoI's samples along y and x on its level: (outside, floor,
    neighbour) [B * N, out, s] each."""
    flat = boxes.reshape(-1, 4)
    sizes = [f.shape[-2:] for f in features]
    lv = assign_fpn_levels(flat, len(features)).long()

    def per_roi(values):
        return torch.tensor(values, dtype=torch.float32, device=boxes.device)[lv]

    (oy, y0, y1, _), (ox, x0, x1, _) = roi_samples(
        flat, per_roi([_infer_scale(hw, image_size) for hw in sizes]),
        per_roi([h for h, _ in sizes]), per_roi([w for _, w in sizes]), output_size,
        sampling_ratio)
    return (oy, y0, y1), (ox, x0, x1)


def staged_rois(features: Sequence[torch.Tensor], boxes: torch.Tensor, image_size,
                output_size=(7, 7), sampling_ratio: int = 2):
    """Which RoIs the kernel pools from a footprint staged in shared memory:
    (staged [B, N] bool, footprint pixels [B, N] int64, the rows times the
    columns ``staging_window`` lists). A RoI is staged when its footprint is
    at most ``STAGE_PIXELS``, the channels are whole 16-byte runs and every
    level map starts on a 16-byte boundary (so does the output, which the
    wrapper allocates); the kernel reads the corners of the others
    directly."""
    rows, cols = staging_window(features, boxes, image_size, output_size, sampling_ratio)
    foot = (rows >= 0).sum(-1) * (cols >= 0).sum(-1)
    runs = 16 // features[0].element_size()
    vectors = features[0].shape[1] % runs == 0 and all(f.data_ptr() % 16 == 0 for f in features)
    return (foot <= STAGE_PIXELS) & vectors, foot


# The backward kernel's constants (csrc/roi_align.cu; change both together):
# channels a block takes at most, the bytes its staged cotangent may take,
# and the share of its samples' corners a footprint must reach for the
# direct route (1 / BWD_DIRECT)
BWD_SLICE, BWD_STAGE_BYTES, BWD_DIRECT = 64, 64 * 1024, 2


def backward_slice(c: int, output_size=(7, 7), sampling_ratio: int = 2) -> int:
    """Channels a backward block takes, as the kernel's ``backward_slice``:
    BWD_SLICE, fewer where their staged cotangent would exceed
    BWD_STAGE_BYTES or a block's items (up to 4 s^2 oh ow footprint pixels
    or sample corners, each with the slice's channels) would reach 2^22,
    all of them where there are fewer; 0 where not even 4 fit (the kernel
    then takes no launch)."""
    oh, ow = output_size
    bins = oh * ow
    fit = min(BWD_STAGE_BYTES // (bins * 4),
              (2 ** 22 - 1) // (4 * bins * sampling_ratio ** 2)) // 4 * 4
    return min(fit, BWD_SLICE) if fit < c else min(c, BWD_SLICE)


def backward_routes(level_shapes: Sequence, boxes: torch.Tensor, image_size,
                    output_size=(7, 7), sampling_ratio: int = 2):
    """How the backward kernel sends each RoI's sums to its level's f32
    cotangent: (staged [B, N] bool, footprint pixels [B, N] int64). A RoI
    whose footprint (the pixels ``staging_window`` lists, any number) is
    under 1 / BWD_DIRECT of its samples' corners, 4 s^2 oh ow, is staged:
    its cotangent goes to shared memory and each footprint pixel is summed
    in registers before one reduction a vector of channels. The others
    take the direct route: one reduction a corner of every sample inside
    the map. ``level_shapes``: [B, C, H_l, W_l] each."""
    maps = [torch.empty(tuple(sh), device="meta") for sh in level_shapes]
    rows, cols = staging_window(maps, boxes, image_size, output_size, sampling_ratio)
    foot = (rows >= 0).sum(-1) * (cols >= 0).sum(-1)
    oh, ow = output_size
    return foot * BWD_DIRECT < 4 * sampling_ratio ** 2 * oh * ow, foot


def backward_reductions(level_shapes: Sequence, boxes: torch.Tensor, image_size,
                        output_size=(7, 7), sampling_ratio: int = 2) -> int:
    """The global reductions one backward launch issues, each of a vector of
    4 channels where the channels come in runs of 4 (float4) and of 1
    otherwise. A block takes one RoI and a slice of channels. Staged: one
    a footprint pixel and vector. Direct: one a vector and corner of every
    sample inside the map."""
    staged, foot = backward_routes(level_shapes, boxes, image_size, output_size,
                                   sampling_ratio)
    maps = [torch.empty(tuple(sh), device="meta") for sh in level_shapes]
    (oy, _, _), (ox, _, _) = _taps(maps, boxes, image_size, output_size, sampling_ratio)
    inside = ((~oy).flatten(1).sum(1) * (~ox).flatten(1).sum(1)).view(foot.shape)
    c = level_shapes[0][1]
    vec = 4 if c % 4 == 0 else 1
    width = backward_slice(c, output_size, sampling_ratio)
    total = 0
    for lo in range(0, c, width):
        vectors = min(width, c - lo) // vec
        total += int(torch.where(staged, foot, 4 * inside).sum()) * vectors
    return total


def _check(features: Sequence[torch.Tensor], boxes: torch.Tensor, sampling_ratio) -> None:
    if not 1 <= len(features) <= MAX_LEVELS:
        raise ValueError(f"expected 1 to {MAX_LEVELS} level maps, got {len(features)}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"expected float32 boxes [B, N, 4], got {boxes.dtype} "
                         f"{tuple(boxes.shape)}")
    b, c = boxes.shape[0], features[0].shape[1]
    for f in features:
        if f.dim() != 4 or f.shape[0] != b or f.shape[1] != c:
            raise ValueError(f"expected level maps [{b}, {c}, H, W], got {tuple(f.shape)}")
        if f.dtype != features[0].dtype or f.dtype not in _DTYPE_CODE:
            raise TypeError(f"level maps must all be float32 or all bfloat16, got {f.dtype}")
    if int(sampling_ratio) < 1:
        raise ValueError(f"sampling_ratio must be positive, got {sampling_ratio}")


def _function():
    fn = load_library("roi_align").roi_align_forward
    if fn.argtypes is None:
        level = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + level * MAX_LEVELS
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def multiscale_roi_align_cuda(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                              image_size, output_size=(7, 7), sampling_ratio: int = 2,
                              route: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel wrapper: CUDA level maps [B, C, H_l, W_l] in channels_last
    memory (NHWC bytes), float32 boxes [B, N, 4] -> [B, N, oh, ow, C] in the
    maps' dtype. ``route``, a uint8 tensor [B, N] if given, receives each
    RoI's level (its ``assign_fpn_levels``, which the kernel computes) times
    2, plus 1 where the kernel staged its footprint in shared memory and 0
    where it read the corners directly."""
    global launches
    _check(features, boxes, sampling_ratio)
    dev = boxes.device
    if route is not None and (route.dtype != torch.uint8 or route.shape != boxes.shape[:2]
                              or not route.is_contiguous()):
        raise ValueError("route must be a contiguous uint8 tensor [B, N]")
    extra = () if route is None else (route,)
    if not all(t.is_cuda and t.device == dev for t in (*features, boxes, *extra)):
        raise ValueError("multiscale_roi_align_cuda needs all its tensors on one CUDA device")
    if not all(f.permute(0, 2, 3, 1).is_contiguous() for f in features):
        raise ValueError("multiscale_roi_align_cuda needs channels_last level maps")
    if not boxes.is_contiguous():
        raise ValueError("multiscale_roi_align_cuda needs contiguous boxes")
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()  # the kernel reads a box as one 16-byte load
    b, n = boxes.shape[:2]
    c = features[0].shape[1]
    oh, ow = output_size
    out = torch.empty((b, n, oh, ow, c), dtype=features[0].dtype, device=dev)
    if b * n == 0:
        return out
    args = []
    for i in range(MAX_LEVELS):
        if i < len(features):
            f = features[i]
            h, w = f.shape[-2:]
            args += [f.data_ptr(), h, w, _infer_scale((h, w), image_size)]
        else:
            args += [None, 0, 0, 0.0]
    with torch.cuda.device(dev):
        err = _function()(_DTYPE_CODE[features[0].dtype], len(features), *args,
                          boxes.data_ptr(), out.data_ptr(),
                          None if route is None else route.data_ptr(), b * n, n, c, oh, ow,
                          int(sampling_ratio), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign kernel failed to launch: CUDA error {err}")
    launches += 1
    return out
