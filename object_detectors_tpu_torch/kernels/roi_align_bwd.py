"""Multiscale RoIAlign backward: the output cotangent [B, N, oh, ow, C] and
the boxes [B, N, 4] -> the cotangent of every level map [B, C, H_l, W_l].

The JAX package has no Pallas kernel for it: it differentiates its pooler
with the XLA VJP of the canvas formulation
(``object_detectors_tpu/ops/roi_align.py:_pool_pallas_bwd``), accumulating
in f32. ``multiscale_roi_align_backward_cuda`` launches the hand-written
kernel of ``csrc/roi_align.cu`` (``roi_align_backward``: each RoI's
footprint pixels summed in registers, or its samples' corners taken one by
one, and added with float4 reductions into one zeroed f32 buffer of all
the levels, then rounded to bf16 for bf16 maps;
``kernels/roi_align.py:backward_routes`` states the routes), or raises;
``multiscale_roi_align_backward_reference`` is the plain version, autograd
of ``kernels/roi_align.py:multiscale_roi_align_reference`` on f32 maps.
Boxes get no cotangent: in training every box that reaches the pooler is a
proposal without gradient or a GT box.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from object_detectors_tpu_torch.kernels._build import load_library
from object_detectors_tpu_torch.kernels.roi_align import (
    _DTYPE_CODE, MAX_LEVELS, backward_slice, multiscale_roi_align_reference,
)
from object_detectors_tpu_torch.ops.roi_align import _infer_scale

# Kernel launches so far; a run sets it to 0 and reads it to show that a
# path went through the kernel.
launches = 0


def _channels_last(shape, dtype, device) -> torch.Tensor:
    b, c, h, w = shape
    return torch.zeros((b, h, w, c), dtype=dtype, device=device).permute(0, 3, 1, 2)


def multiscale_roi_align_backward_reference(grad: torch.Tensor, boxes: torch.Tensor,
                                            level_shapes: Sequence, image_size,
                                            output_size=(7, 7), sampling_ratio: int = 2,
                                            dtype: torch.dtype = torch.float32):
    """Plain version: autograd of the plain pooler on zero f32 maps of
    ``level_shapes`` ([B, C, H_l, W_l] each), the f32 cotangents rounded to
    ``dtype`` at the end, channels_last."""
    with torch.enable_grad():
        maps = [_channels_last(shape, torch.float32, grad.device).requires_grad_()
                for shape in level_shapes]
        out = multiscale_roi_align_reference(maps, boxes, image_size, output_size,
                                             sampling_ratio)
        grads = torch.autograd.grad(out, maps, grad.float())
    return [g.to(dtype).contiguous(memory_format=torch.channels_last) for g in grads]


def _function():
    fn = load_library("roi_align").roi_align_backward
    if fn.argtypes is None:
        level = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        fn.argtypes = ([ctypes.c_int, ctypes.c_int] + level * MAX_LEVELS
                       + [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def multiscale_roi_align_backward_cuda(grad: torch.Tensor, boxes: torch.Tensor,
                                       level_shapes: Sequence, image_size,
                                       output_size=(7, 7), sampling_ratio: int = 2,
                                       dtype: torch.dtype = torch.float32,
                                       route: torch.Tensor | None = None):
    """Kernel wrapper: a CUDA cotangent [B, N, oh, ow, C] (f32 or bf16) and
    f32 boxes [B, N, 4] -> the cotangents of the level maps of
    ``level_shapes`` in ``dtype`` (f32 or bf16), channels_last. ``route``,
    a uint8 tensor [B, N] if given, receives each RoI's level times 2, plus
    1 where the kernel staged its cotangent and summed each footprint pixel
    before reducing it, 0 where it reduced every sample's corners directly
    (``backward_routes``)."""
    global launches
    if not 1 <= len(level_shapes) <= MAX_LEVELS:
        raise ValueError(f"expected 1 to {MAX_LEVELS} level maps, got {len(level_shapes)}")
    if dtype not in _DTYPE_CODE or grad.dtype not in _DTYPE_CODE:
        raise TypeError(f"expected float32 or bfloat16, got maps {dtype}, grad {grad.dtype}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"expected float32 boxes [B, N, 4], got {boxes.dtype} "
                         f"{tuple(boxes.shape)}")
    b, n = boxes.shape[:2]
    oh, ow = output_size
    c = level_shapes[0][1]
    if tuple(grad.shape) != (b, n, oh, ow, c):
        raise ValueError(f"expected a cotangent {(b, n, oh, ow, c)}, got {tuple(grad.shape)}")
    if any(tuple(s[:2]) != (b, c) for s in level_shapes):
        raise ValueError(f"expected level maps [{b}, {c}, H, W], got {level_shapes}")
    if int(sampling_ratio) < 1:
        raise ValueError(f"sampling_ratio must be positive, got {sampling_ratio}")
    if backward_slice(c, output_size, int(sampling_ratio)) == 0:
        raise ValueError(f"a {oh}x{ow} output at sampling_ratio {sampling_ratio} is too large "
                         f"for the backward kernel: a block of 4 channels must stay under "
                         f"2^22 items (4 s^2 oh ow x 4) and 64 KiB of staged cotangent")
    if route is not None and (route.dtype != torch.uint8 or route.shape != boxes.shape[:2]
                              or not route.is_contiguous()):
        raise ValueError("route must be a contiguous uint8 tensor [B, N]")
    dev = boxes.device
    extra = () if route is None else (route,)
    if not all(t.is_cuda and t.device == dev for t in (grad, boxes, *extra)):
        raise ValueError("multiscale_roi_align_backward_cuda needs its tensors on one CUDA "
                         "device")
    grad = grad.contiguous()
    if grad.data_ptr() % 16:
        grad = grad.clone()  # read 4 channels at a time
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()  # the kernel reads a box as one 16-byte load
    sizes = [b * h * w * c for _, _, h, w in level_shapes]
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    out = acc if dtype == torch.float32 else torch.empty(sum(sizes), dtype=dtype, device=dev)
    args, start = [], 0
    for i in range(MAX_LEVELS):
        if i < len(level_shapes):
            h, w = level_shapes[i][2:]
            args += [acc.data_ptr() + start * 4, h, w, _infer_scale((h, w), image_size)]
            start += sizes[i]
        else:
            args += [None, 0, 0, 0.0]
    with torch.cuda.device(dev):
        err = _function()(_DTYPE_CODE[grad.dtype], len(level_shapes), *args, boxes.data_ptr(),
                          grad.data_ptr(), None if out is acc else out.data_ptr(),
                          None if route is None else route.data_ptr(), out.numel(), b * n,
                          max(n, 1), c, oh, ow, int(sampling_ratio),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"RoIAlign backward kernel failed to launch: CUDA error {err}")
    launches += 1
    return [level.view(b, h, w, c).permute(0, 3, 1, 2)
            for level, (_, _, h, w) in zip(out.split(sizes), level_shapes)]


def multiscale_roi_align_backward(grad: torch.Tensor, boxes: torch.Tensor,
                                  level_shapes: Sequence, image_size, output_size=(7, 7),
                                  sampling_ratio: int = 2, dtype: torch.dtype = torch.float32):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if boxes.is_cuda:
        return multiscale_roi_align_backward_cuda(grad, boxes, level_shapes, image_size,
                                                  output_size, sampling_ratio, dtype)
    if boxes.device.type != "cpu":
        raise ValueError(f"no RoIAlign backward for device {boxes.device}")
    return multiscale_roi_align_backward_reference(grad, boxes, level_shapes, image_size,
                                                   output_size, sampling_ratio, dtype)
