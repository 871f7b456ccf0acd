"""Fused ResNet bottleneck block, eval path (port of
``object_detectors_tpu/kernels/fused_block.py``).

A stride-1 bottleneck with FrozenBatchNorm folded into its convolutions:
1x1 + shift + ReLU -> 3x3 (zero padding) + shift + ReLU -> 1x1 + shift,
plus the identity or a 1x1 projection + shift, then ReLU. bf16 in and out,
f32 accumulation; t1 and t2 are rounded to bf16 between the stages, as the
TPU kernel rounds them.

``fold_bn`` folds the batch norm into a weight. ``fused_bottleneck_cuda``
launches the hand-written kernel of ``csrc/fused_block.cu`` (or raises);
``fused_bottleneck_reference`` is the plain version; ``fused_bottleneck``
takes the kernel for a CUDA tensor and the plain version for a CPU one.

Tensors are the port's: x [B, Cin, H, W] (channels_last memory for the
kernel), weights as torch convolutions hold them ([Cout, Cin, kh, kw], bf16
after folding), shifts f32.
"""

from __future__ import annotations

import ctypes
from typing import Mapping

import torch
import torch.nn.functional as F

from object_detectors_tpu_torch.kernels._build import load_library

# Kernel launches so far; a run sets it to 0 and reads it to show that a
# path went through the kernel.
launches = 0


def fold_bn(weight: torch.Tensor, frozen: Mapping[str, torch.Tensor], eps: float = 1e-5):
    """Fold FrozenBatchNorm (``weight``, ``bias``, ``running_mean``,
    ``running_var``) into a conv weight [Cout, ...]: returns (weight * scale
    on the output axis, taken in f32 and rounded to bf16 once; shift f32). The f32 square root is taken in f64 and rounded once, which is
    the correctly rounded f32 root that JAX computes (PyTorch's vectorized
    f32 root on the CPU can be one ulp off)."""
    root = torch.sqrt((frozen["running_var"] + eps).double()).float()
    s = frozen["weight"] / root
    shift = frozen["bias"] - frozen["running_mean"] * s
    scale = s.reshape(-1, *([1] * (weight.dim() - 1)))
    return (weight.float() * scale).to(torch.bfloat16), shift.float()


def fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> torch.Tensor:
    """Plain PyTorch version: f32 convolutions of the bf16 values, rounded
    where the TPU kernel rounds (t1, t2, the output). Returns bf16
    [B, Cout, H, W] in channels_last memory."""
    def conv(t, wt, shift, padding=0):
        return F.conv2d(t, wt.float(), padding=padding) + shift.float()[:, None, None]

    xf = x.float()
    t1 = F.relu(conv(xf, w1, b1)).to(torch.bfloat16)  # conv2 zero-pads t1 itself
    t2 = F.relu(conv(t1.float(), w2, b2, 1)).to(torch.bfloat16)
    t3 = conv(t2.float(), w3, b3)
    ident = conv(xf, wd, bd) if wd is not None else xf
    return F.relu(t3 + ident).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def max_mid_channels() -> int:
    """The largest Cm the kernel takes (its shared-memory limit)."""
    return int(load_library("fused_block").fused_bottleneck_max_mid())


def _check(x, w1, b1, w2, b2, w3, b3, wd, bd) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise TypeError(f"expected bf16 x [B, Cin, H, W], got {x.dtype} {tuple(x.shape)}")
    cin, cm, cout = x.shape[1], w1.shape[0], w3.shape[0]
    shapes = [(w1, (cm, cin, 1, 1)), (w2, (cm, cm, 3, 3)), (w3, (cout, cm, 1, 1)),
              (b1, (cm,)), (b2, (cm,)), (b3, (cout,))]
    if wd is not None:
        shapes += [(wd, (cout, cin, 1, 1)), (bd, (cout,))]
    elif cout != cin:
        raise ValueError(f"an identity block needs Cout == Cin, got {cout} and {cin}")
    for t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"expected a tensor of shape {shape}, got {tuple(t.shape)}")
    for t in (w1, w2, w3) + (() if wd is None else (wd,)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"folded weights must be bf16, got {t.dtype}")
    for t in (b1, b2, b3) + (() if bd is None else (bd,)):
        if t.dtype != torch.float32:
            raise TypeError(f"shifts must be float32, got {t.dtype}")
    if cin % 8 or cm % 8 or cout % 8:
        raise ValueError(f"the fused block kernel needs channel counts that are multiples "
                         f"of 8, got Cin {cin}, Cm {cm}, Cout {cout}")


def _function():
    fn = load_library("fused_block").fused_bottleneck_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> torch.Tensor:
    """Kernel wrapper: x bf16 [B, Cin, H, W] on a CUDA device in channels_last
    memory, folded weights and shifts as ``fold_bn`` gives them -> bf16
    [B, Cout, H, W] in channels_last memory."""
    global launches
    _check(x, w1, b1, w2, b2, w3, b3, wd, bd)
    tensors = (x, w1, b1, w2, b2, w3, b3) + (() if wd is None else (wd, bd))
    dev = x.device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("fused_bottleneck_cuda needs all its tensors on one CUDA device")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("fused_bottleneck_cuda needs x in channels_last memory, 16-byte aligned")
    b, cin, h, w = x.shape
    cm, cout = w1.shape[0], w3.shape[0]
    if cm > max_mid_channels():
        raise ValueError(f"fused_bottleneck_cuda takes at most {max_mid_channels()} middle "
                         f"channels, got {cm}")
    # the kernel's [N][K] weights: output channel major, input channel contiguous
    w1k = w1.reshape(cm, cin).contiguous()
    w2k = w2.permute(2, 3, 0, 1).contiguous()  # [3, 3, Cm_out, Cm_in]
    w3k = w3.reshape(cout, cm).contiguous()
    wdk = None if wd is None else wd.reshape(cout, cin).contiguous()
    shifts = [t.contiguous() for t in (b1, b2, b3)] + [None if bd is None else bd.contiguous()]
    out = torch.empty((b, cout, h, w), dtype=torch.bfloat16, device=dev,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _function()(x.data_ptr(), w1k.data_ptr(), shifts[0].data_ptr(), w2k.data_ptr(),
                          shifts[1].data_ptr(), w3k.data_ptr(), shifts[2].data_ptr(),
                          None if wdk is None else wdk.data_ptr(),
                          None if wdk is None else shifts[3].data_ptr(), out.data_ptr(),
                          b, h, w, cin, cm, cout, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused bottleneck kernel failed to launch: CUDA error {err}")
    launches += 1
    return out


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if x.device.type != "cpu":
        raise ValueError(f"no fused bottleneck for device {x.device}")
    return fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd, bd)
