"""Fused image normalize: uint8 NHWC -> (x/255 - mean) / std, one pass.

Port of ``object_detectors_tpu/kernels/preprocess.py``. On a CUDA tensor
``preprocess_images`` launches the hand-written kernel in
``csrc/preprocess.cu`` (or raises); on a CPU tensor it runs the plain
version, which performs the kernel's three f32 steps in the same order
(multiply by f32(1/255), subtract the mean, multiply by f32(1/std)), so the
two agree bitwise on the GPU.

The kernel writes NHWC bytes into an NCHW ``channels_last`` tensor and the
function returns its ``[B, H, W, 3]`` view: the first convolution reads it
without a transpose.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from object_detectors_tpu_torch.kernels._build import load_library

# ImageNet statistics, as the JAX package's data/transforms.py keeps them.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

SCALE = np.float32(1.0 / 255.0)
INV_STD = (1.0 / IMAGENET_STD.astype(np.float64)).astype(np.float32)

# Kernel launches so far; a run sets it to 0 and reads it to show that a
# path went through the kernel.
launches = 0

_ENTRY = {torch.bfloat16: "preprocess_u8_bf16", torch.float32: "preprocess_u8_f32"}


def preprocess_images_reference(images: torch.Tensor,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: [B, H, W, 3] uint8 -> [B, H, W, 3] out_dtype."""
    dev = images.device
    x = images.to(torch.float32)
    x = x * torch.tensor(SCALE, device=dev)
    x = x - torch.from_numpy(IMAGENET_MEAN).to(dev)
    x = x * torch.from_numpy(INV_STD).to(dev)
    return x.to(out_dtype)


def _check(images: torch.Tensor, out_dtype) -> None:
    if images.dtype != torch.uint8:
        raise TypeError(f"expected uint8 images, got {images.dtype}")
    if images.dim() != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected [B, H, W, 3] images, got {tuple(images.shape)}")
    if out_dtype not in _ENTRY:
        raise TypeError(f"out_dtype must be one of {list(_ENTRY)}, got {out_dtype}")


def _function(out_dtype):
    fn = getattr(load_library("preprocess"), _ENTRY[out_dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       *([ctypes.c_float] * 7), ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def preprocess_images_cuda(images: torch.Tensor,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel wrapper: a contiguous CUDA uint8 batch -> [B, H, W, 3] view of
    a channels_last [B, 3, H, W] tensor."""
    global launches
    _check(images, out_dtype)
    if not images.is_cuda:
        raise ValueError("preprocess_images_cuda needs a CUDA tensor")
    if not images.is_contiguous():
        raise ValueError("preprocess_images_cuda needs a contiguous tensor")
    b, h, w, _ = images.shape
    out = torch.empty((b, 3, h, w), dtype=out_dtype, device=images.device,
                      memory_format=torch.channels_last)
    n = images.numel()
    if n:
        fn = _function(out_dtype)
        with torch.cuda.device(images.device):
            sms = torch.cuda.get_device_properties(images.device).multi_processor_count
            err = fn(images.data_ptr(), out.data_ptr(), n, float(SCALE),
                     *(float(v) for v in IMAGENET_MEAN),
                     *(float(v) for v in INV_STD), sms,
                     torch.cuda.current_stream(images.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"preprocess kernel failed to launch: CUDA error {err}")
        launches += 1
    return out.permute(0, 2, 3, 1)


def preprocess_images(images: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Normalize a uint8 [B, H, W, 3] batch: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if images.is_cuda:
        return preprocess_images_cuda(images, out_dtype)
    if images.device.type != "cpu":
        raise ValueError(f"no preprocess path for device {images.device}")
    _check(images, out_dtype)
    return preprocess_images_reference(images, out_dtype)


# --- device-ingest resizes --------------------------------------------------
# Port of the JAX package's kernels/preprocess.py:118-278. JAX computes these
# with XLA einsums outside any pallas_call, so here they are plain PyTorch:
# two batched products against per-image sampling matrices, built in f32 as
# JAX builds them (a per-image scale changes the matrices' values, never
# their shapes). The products run in f32 without TF32 (PyTorch's default
# for matmul on the GPU). Every division is of two tensors: PyTorch's CUDA
# kernel divides by a Python number as a multiply by its rounded reciprocal,
# and ``number / tensor`` is a reciprocal times the number on every device,
# each up to an ulp off the quotient JAX takes, and an ulp of a scale moves
# the sample positions of a whole row of outputs.

def cubic_kernel(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """Cubic convolution kernel (Keys). a=-0.75 matches cv2 INTER_CUBIC
    and PyTorch bicubic, the reference's resize."""
    at = t.abs()
    return torch.where(
        at <= 1.0, ((a + 2.0) * at - (a + 3.0)) * at * at + 1.0,
        torch.where(at < 2.0, a * (((at - 5.0) * at + 8.0) * at - 4.0),
                    torch.zeros_like(at)))


def bicubic_rows(scale: torch.Tensor, limit: torch.Tensor, n_in: int,
                 n_out: int) -> torch.Tensor:
    """[..., n_out, n_in] bicubic sampling matrices for f32 ``scale`` and
    ``limit`` of shape [...]: output row i samples the input at
    (i + 0.5) * scale - 0.5, 4 taps at floor-1..floor+2 clamped to
    [0, limit) (border replication); ``limit`` <= n_in masks the valid prefix
    of a padded canvas."""
    dev = scale.device
    scale = scale[..., None]
    limit = limit[..., None, None]
    i = torch.arange(n_out, dtype=torch.float32, device=dev)
    center = (i + 0.5) * scale - 0.5
    i0 = torch.floor(center)
    t = center - i0
    ws = torch.stack([cubic_kernel(t + 1.0), cubic_kernel(t),
                      cubic_kernel(t - 1.0), cubic_kernel(t - 2.0)], -1)
    offsets = torch.arange(-1.0, 3.0, dtype=torch.float32, device=dev)
    taps = torch.minimum(torch.clamp(i0[..., None] + offsets, min=0.0), limit - 1.0)
    m = torch.arange(n_in, dtype=torch.float32, device=dev)
    return (ws[..., None] * (taps[..., None] == m)).sum(-2)


def _normalize_resized(x: torch.Tensor) -> torch.Tensor:
    """(x / 255 - mean) / std in f32, as the JAX resizes' epilogue."""
    dev = x.device
    return (x * float(SCALE) - torch.from_numpy(IMAGENET_MEAN).to(dev)) \
        / torch.from_numpy(IMAGENET_STD).to(dev)


def _resample(canvas: torch.Tensor, ky: torch.Tensor, kx: torch.Tensor) -> torch.Tensor:
    """[B, Hc, Wc, C] through ky [B, oh, Hc] and kx [B, ow, Wc] -> f32
    [B, oh, ow, C]: JAX's two einsums."""
    x = canvas.to(torch.float32)
    x = torch.einsum("boh,bhwc->bowc", ky, x)
    return torch.einsum("bowc,bpw->bopc", x, kx)


def resize_normalize_from_canvas(canvas: torch.Tensor, sizes: torch.Tensor, out_dim: int,
                                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """Batched per-image square resize + normalize on the canvas's device.

    canvas: [B, Hc, Wc, 3] uint8, each image placed top-left at its native
    resolution (``data.coco.yolo_batches_uint8``). sizes: [B, 2] (h, w)
    true sizes. Each image bicubic-resizes (a=-0.75, the reference's cv2
    INTER_CUBIC square resize) from its own (h, w) to (out_dim, out_dim),
    then /255 and the ImageNet normalize: [B, out_dim, out_dim, 3]
    ``out_dtype``."""
    _, hc, wc, _ = canvas.shape
    sizes = sizes.to(canvas.device)
    h = sizes[:, 0].to(torch.float32)
    w = sizes[:, 1].to(torch.float32)
    out = torch.full_like(h, out_dim)
    ky = bicubic_rows(h / out, h, hc, out_dim)   # [B, out, Hc]
    kx = bicubic_rows(w / out, w, wc, out_dim)   # [B, out, Wc]
    return _normalize_resized(_resample(canvas, ky, kx)).to(out_dtype)


def bilinear_rows(ratio: torch.Tensor, limit: torch.Tensor, n_in: int, n_out: int,
                  n_valid: torch.Tensor) -> torch.Tensor:
    """[..., n_out, n_in] bilinear sampling matrices with masked rows, for f32
    ``ratio``, ``limit`` and ``n_valid`` of shape [...]: output row i
    (i < n_valid) samples the input at (i + 0.5) * ratio - 0.5 with 2 taps
    clamped to [0, limit) (F.interpolate bilinear, align_corners=False / cv2
    INTER_LINEAR centers); rows >= n_valid are zero (the pad of a canvas)."""
    dev = ratio.device
    ratio = ratio[..., None]
    limit = limit[..., None, None]
    i = torch.arange(n_out, dtype=torch.float32, device=dev)
    center = (i + 0.5) * ratio - 0.5
    i0 = torch.floor(center)
    t = center - i0
    ws = torch.stack([1.0 - t, t], -1)
    offsets = torch.arange(0.0, 2.0, dtype=torch.float32, device=dev)
    taps = torch.minimum(torch.clamp(i0[..., None] + offsets, min=0.0), limit - 1.0)
    m = torch.arange(n_in, dtype=torch.float32, device=dev)
    rows = (ws[..., None] * (taps[..., None] == m)).sum(-2)
    return torch.where((i < n_valid[..., None])[..., None], rows, torch.zeros_like(rows))


def rcnn_resize_normalize_from_canvas(canvas: torch.Tensor, sizes: torch.Tensor,
                                      out_hw: tuple, min_size: int = 800,
                                      max_size: int = 1333, out_dtype=torch.float32,
                                      min_sizes: torch.Tensor | None = None):
    """GeneralizedRCNNTransform ingest on the canvas's device: per image an
    aspect-preserving bilinear resize, /255, the ImageNet normalize and a
    zero pad to ``out_hw``.

    canvas: [B, Hc, Wc, 3] uint8 at native resolution, top-left. sizes:
    [B, 2] (h, w) true sizes. Per image scale = min(min_size / min side,
    max_size / max side), capped by the canvas ``out_hw``; the target is
    round(scale * (h, w)) (half to even, as jnp.round). ``min_sizes`` ([B])
    replaces ``min_size`` per image (the train path's drawn sizes).

    Returns (images [B, ph, pw, 3] out_dtype, new_sizes [B, 2] int32,
    scales [B] f32)."""
    _, hc, wc, _ = canvas.shape
    ph, pw = out_hw
    dev = canvas.device
    sizes = sizes.to(dev)
    h = sizes[:, 0].to(torch.float32)
    w = sizes[:, 1].to(torch.float32)
    ms = (torch.as_tensor(min_sizes).to(dev, torch.float32) if min_sizes is not None
          else torch.full_like(h, min_size))
    scale = torch.minimum(ms / torch.minimum(h, w),
                          torch.full_like(h, max_size) / torch.maximum(h, w))
    scale = torch.minimum(scale, torch.minimum(torch.full_like(h, ph) / h,
                                               torch.full_like(w, pw) / w))
    nh = torch.round(h * scale)
    nw = torch.round(w * scale)
    ky = bilinear_rows(h / nh, h, hc, ph, nh)   # [B, ph, Hc]
    kx = bilinear_rows(w / nw, w, wc, pw, nw)   # [B, pw, Wc]
    x = _normalize_resized(_resample(canvas, ky, kx))
    valid = ((torch.arange(ph, device=dev)[None, :, None] < nh[:, None, None])
             & (torch.arange(pw, device=dev)[None, None, :] < nw[:, None, None]))
    x = torch.where(valid[..., None], x, torch.zeros_like(x))
    new_sizes = torch.stack([nh, nw], -1).to(torch.int32)
    return x.to(out_dtype), new_sizes, scale


def resize_normalize_images(images: torch.Tensor, out_hw: tuple, out_dtype=torch.bfloat16,
                            antialias: bool = False) -> torch.Tensor:
    """uint8 [B, H0, W0, 3] -> bilinear resize to ``out_hw`` (half-pixel
    centers; ``antialias`` widens the triangle on a downscale) -> /255 ->
    ImageNet normalize -> ``out_dtype``: the JAX package's
    ``jax.image.resize(..., "bilinear", antialias=antialias)`` path, here
    ``F.interpolate(mode="bilinear", align_corners=False)``."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    x = torch.nn.functional.interpolate(x, size=tuple(out_hw), mode="bilinear",
                                        align_corners=False, antialias=antialias)
    return _normalize_resized(x.permute(0, 2, 3, 1)).to(out_dtype)
