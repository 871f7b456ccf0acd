"""Fused ResNet bottleneck block, eval path (port of
``object_detectors_tpu/kernels/fused_block.py``).

A stride-1 bottleneck with FrozenBatchNorm folded into its convolutions:
1x1 + shift + ReLU -> 3x3 (zero padding) + shift + ReLU -> 1x1 + shift,
plus the identity or a 1x1 projection + shift, then ReLU. bf16 in and out,
f32 accumulation; t1 and t2 are rounded to bf16 between the stages, as the
TPU kernel rounds them.

``fold_bn`` folds the batch norm into a weight. ``PreparedBlock`` holds a
block's folded weights and, once a CUDA launch needs them, the same weights
in the kernel's layout with their TMA descriptors, so that a caller that
keeps it (``models/resnet.py`` caches one per parameter version) pays for
neither again. ``fused_block_cuda`` launches the hand-written kernel of
``csrc/fused_block.cu`` on a prepared block (or raises);
``fused_bottleneck_cuda`` does the same on loose folded weights;
``fused_bottleneck_reference`` is the plain version; ``fused_bottleneck``
takes the kernel for a CUDA tensor and the plain version for a CPU one.

The kernel source holds two variants and chooses by shape, never on a
failure: v4 (TMA, wgmma) for channel counts that are multiples of 64 with
64 <= Cm <= 512, the ResNet-50 blocks; v2 (mma.sync, cp.async) for the other
multiples of 8 up to Cm 576. ``launch_config`` says which one a shape takes
and how it is tiled.

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


def launch_config(batch: int, h: int, w: int, cin: int, cm: int, cout: int) -> dict:
    """The variant the kernel source chooses for a shape and how it tiles
    it: variant (4 or 2), cluster size, output tile (tile_h x tile_w pixels
    a CTA), grid (CTAs) and the CTAs that run at once on one SM."""
    vals = (ctypes.c_int * 6)()
    err = load_library("fused_block").fused_bottleneck_config(batch, h, w, cin, cm, cout, vals)
    if err != 0:
        raise ValueError(f"the fused block kernel takes no block with Cin {cin}, Cm {cm}, "
                         f"Cout {cout} (CUDA error {err})")
    keys = ("variant", "cluster", "tile_h", "tile_w", "ctas", "ctas_per_sm")
    return dict(zip(keys, (int(v) for v in vals)))


def _check(x, w1, b1, w2, b2, w3, b3, wd, bd) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise TypeError(f"expected bf16 x [B, Cin, H, W], got {x.dtype} {tuple(x.shape)}")
    _check_weights(x.shape[1], w1, b1, w2, b2, w3, b3, wd, bd)


def _check_weights(cin, w1, b1, w2, b2, w3, b3, wd, bd) -> None:
    cm, cout = w1.shape[0], w3.shape[0]
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


class PreparedBlock:
    """A block's folded weights and shifts (as ``fold_bn`` gives them), and,
    built at the first CUDA launch and kept, the kernel's operands: bf16
    [N][K] weights (w1 [Cm][Cin], w2 [3][3][Cm][Cm], w3 [Cout][Cm], wd
    [Cout][Cin]), contiguous f32 shifts, and the TMA descriptors of the four
    weights (512 bytes of host memory, encoded by the kernel source)."""

    def __init__(self, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
        _check_weights(w1.shape[1], w1, b1, w2, b2, w3, b3, wd, bd)
        self.folded = (w1, b1, w2, b2, w3, b3, wd, bd)
        self.cin, self.cm, self.cout = w1.shape[1], w1.shape[0], w3.shape[0]
        self._operands = None

    def operands(self):
        """(the laid-out tensors, their pointers in the launch's order, the
        descriptor buffer), built once."""
        if self._operands is None:
            w1, b1, w2, b2, w3, b3, wd, bd = self.folded
            dev = w1.device
            if not all(t is None or (t.is_cuda and t.device == dev) for t in self.folded):
                raise ValueError("fused_bottleneck_cuda needs all its tensors on one CUDA device")
            cin, cm, cout = self.cin, self.cm, self.cout
            keep = [w1.reshape(cm, cin).contiguous(), b1.contiguous(),
                    w2.permute(2, 3, 0, 1).contiguous(),  # [3, 3, Cm_out, Cm_in]
                    b2.contiguous(), w3.reshape(cout, cm).contiguous(), b3.contiguous(),
                    None if wd is None else wd.reshape(cout, cin).contiguous(),
                    None if bd is None else bd.contiguous()]
            ptrs = [None if t is None else t.data_ptr() for t in keep]
            maps = ctypes.create_string_buffer(_MAP_BYTES)
            err = _lib_function("fused_bottleneck_encode_weights")(
                ptrs[0], ptrs[2], ptrs[4], ptrs[6], cin, cm, cout, maps)
            if err != 0:
                raise RuntimeError(f"fused bottleneck: encoding the weights' TMA descriptors "
                                   f"failed: CUDA error {err}")
            self._operands = (keep, ptrs, maps)
        return self._operands


_MAP_BYTES = 4 * 128  # four CUtensorMap
_ARGTYPES = {
    "fused_bottleneck_bf16": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2,
    "fused_bottleneck_encode_weights": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


def _lib_function(name):
    fn = getattr(load_library("fused_block"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def fused_block_cuda(x: torch.Tensor, block: PreparedBlock) -> torch.Tensor:
    """Kernel wrapper: x bf16 [B, Cin, H, W] on a CUDA device in channels_last
    memory and a prepared block on the same device -> bf16 [B, Cout, H, W] in
    channels_last memory. Nothing is folded or laid out again once ``block``
    has launched once."""
    global launches
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise TypeError(f"expected bf16 x [B, Cin, H, W], got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] != block.cin:
        raise ValueError(f"x has {x.shape[1]} channels, the block takes {block.cin}")
    dev = x.device
    if not x.is_cuda or block.folded[0].device != dev:
        raise ValueError("fused_bottleneck_cuda needs all its tensors on one CUDA device")
    if not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError("fused_bottleneck_cuda needs x in channels_last memory, 16-byte aligned")
    b, cin, h, w = x.shape
    cm, cout = block.cm, block.cout
    if cm > max_mid_channels():
        raise ValueError(f"fused_bottleneck_cuda takes at most {max_mid_channels()} middle "
                         f"channels, got {cm}")
    _, p, maps = block.operands()
    out = torch.empty((b, cout, h, w), dtype=torch.bfloat16, device=dev,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib_function("fused_bottleneck_bf16")(
            x.data_ptr(), *p[:8], out.data_ptr(), b, h, w, cin, cm, cout, maps,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused bottleneck kernel failed to launch: CUDA error {err}")
    launches += 1
    return out


def fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> torch.Tensor:
    """Kernel wrapper on loose folded weights and shifts (as ``fold_bn``
    gives them): lays them out for the kernel at each call."""
    _check(x, w1, b1, w2, b2, w3, b3, wd, bd)
    tensors = (x, w1, b1, w2, b2, w3, b3) + (() if wd is None else (wd, bd))
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_bottleneck_cuda needs all its tensors on one CUDA device")
    return fused_block_cuda(x, PreparedBlock(w1, b1, w2, b2, w3, b3, wd, bd))


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if x.device.type != "cpu":
        raise ValueError(f"no fused bottleneck for device {x.device}")
    return fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd, bd)
