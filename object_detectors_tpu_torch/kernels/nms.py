"""Greedy NMS over groups of boxes: keep indices in greedy order.

Port of ``object_detectors_tpu/kernels/nms_pallas.py`` (``nms_pallas``)
with a group dimension. ``greedy_nms_cuda`` launches the hand-written
kernels in ``csrc/nms.cu`` (or raises): a sort, a bitmask of IoU > threshold
decisions over 64-box chunks, and a sweep by one warp a group, in scratch
laid out by ``scratch_layout``. ``greedy_nms_reference`` is the plain
version, the K-step select-max of the TPU kernel run over all groups at
once, with the IoU formula of ``ops/boxes.py:pairwise_iou``. The two return
the same indices: the kernel is built with -fmad=false, so each IoU > thr
decision is the same float comparison on both.

A box is dead when its score is -inf or NaN or its valid flag is False.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from object_detectors_tpu_torch.kernels._build import load_library
from object_detectors_tpu_torch.ops.boxes import pairwise_iou

# Kernel launches so far; a run sets it to 0 and reads it to show that a
# path went through the kernel.
launches = 0


def greedy_nms_reference(boxes: torch.Tensor, scores: torch.Tensor,
                         iou_threshold: float, max_output: int,
                         valid: torch.Tensor | None = None):
    """Plain PyTorch version: boxes [G, N, 4], scores [G, N] -> (keep [G, K]
    int32 padded with -1, valid [G, K] bool), K = max_output."""
    g, n = scores.shape
    dev = scores.device
    keep = torch.full((g, max_output), -1, dtype=torch.int32, device=dev)
    kept_ok = torch.zeros((g, max_output), dtype=torch.bool, device=dev)
    alive = scores.float()
    if valid is not None:
        alive = torch.where(valid, alive, float("-inf"))
    alive = torch.where(alive > float("-inf"), alive, float("-inf"))  # NaN: dead
    rows = torch.arange(g, device=dev)
    col = torch.arange(n, device=dev)
    for step in range(max_output if n else 0):
        i = torch.argmax(alive, dim=1)  # first of equal maxima: lowest index
        ok = alive[rows, i] > float("-inf")
        if not bool(ok.any()):
            break
        keep[:, step] = torch.where(ok, i, -1).to(torch.int32)
        kept_ok[:, step] = ok
        iou = pairwise_iou(boxes[rows, i][:, None], boxes)[:, 0]  # [G, N]
        kill = (iou > iou_threshold) | (col[None, :] == i[:, None])
        alive = torch.where(ok[:, None] & kill, float("-inf"), alive)
    return keep, kept_ok


def _check(boxes: torch.Tensor, scores: torch.Tensor, valid) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"expected boxes [G, N, 4] and scores [G, N], got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"expected float32 boxes and scores, got {boxes.dtype}, "
                        f"{scores.dtype}")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != scores.shape):
        raise ValueError("valid must be a bool tensor shaped like scores")


CHUNK = 64  # boxes one mask word covers (kChunk in csrc/nms.cu)


@functools.lru_cache(maxsize=64)
def scratch_layout(groups: int, n: int) -> tuple[int, tuple[int, ...]]:
    """The kernel's scratch for ``groups`` groups of ``n`` boxes, one
    allocation: (its bytes, the byte offsets of the sorted order (int32),
    boxes (4 x f32) and areas (f32) [groups, n], the live count of each
    group (int32) and the IoU mask (uint64 [groups, n, words]) in the
    kernel's argument order). A mask row holds ceil(n / 64) words rounded up
    to even, so that a chunk's rows are one 16-byte-aligned copy; the mask
    comes first and every part starts 16-byte aligned."""
    words = -(-n // CHUNK)
    words += words % 2
    sizes = dict(mask=groups * n * words * 8, sorted=groups * n * 16, order=groups * n * 4,
                 area=groups * n * 4, live=groups * 4)
    offsets, at = {}, 0
    for name, size in sizes.items():
        offsets[name] = at
        at += -(-size // 16) * 16
    return at, tuple(offsets[k] for k in ("order", "sorted", "area", "live", "mask"))


def max_boxes() -> int:
    """The largest N one group may hold (the kernel's shared-memory limit)."""
    return int(load_library("nms").greedy_nms_max_n())


def _function():
    fn = load_library("nms").greedy_nms_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                                ctypes.c_int] + [ctypes.c_void_p] * 8)
        fn.restype = ctypes.c_int
    return fn


def greedy_nms_cuda(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                    max_output: int, valid: torch.Tensor | None = None):
    """Kernel wrapper: contiguous CUDA boxes [G, N, 4] and scores [G, N]
    float32, N <= ``max_boxes()`` -> (keep [G, K] int32, valid [G, K] bool)."""
    global launches
    _check(boxes, scores, valid)
    tensors = (boxes, scores) if valid is None else (boxes, scores, valid)
    if not all(t.is_cuda and t.device == boxes.device for t in tensors):
        raise ValueError("greedy_nms_cuda needs all its tensors on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("greedy_nms_cuda needs contiguous tensors")
    g, n = scores.shape
    if n > max_boxes():
        raise ValueError(f"greedy_nms_cuda takes at most {max_boxes()} boxes a group, "
                         f"got {n}")
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()  # the kernel reads a box as one 16-byte load
    keep = torch.empty((g, max_output), dtype=torch.int32, device=boxes.device)
    kept_ok = torch.empty((g, max_output), dtype=torch.bool, device=boxes.device)
    if g and max_output:
        nbytes, offsets = scratch_layout(g, n)
        tmp = torch.empty(nbytes, dtype=torch.uint8, device=boxes.device)
        base = tmp.data_ptr()
        with torch.cuda.device(boxes.device):
            err = _function()(boxes.data_ptr(), scores.data_ptr(),
                              None if valid is None else valid.data_ptr(), g, n,
                              float(iou_threshold), max_output,
                              *(base + off for off in offsets), keep.data_ptr(),
                              kept_ok.data_ptr(),
                              torch.cuda.current_stream(boxes.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"greedy NMS kernel failed to launch: CUDA error {err}")
        launches += 1
    return keep, kept_ok
