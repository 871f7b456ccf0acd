"""Shared building blocks (port of the JAX package's ``models/common.py``).

Layout: NCHW tensors in ``channels_last`` memory. Parameters stay float32;
a convolution runs in its input's dtype (bfloat16 in production, float32 in
the tests), and batch norm takes the low-precision input with its float32
statistics, as the Flax modules do with ``param_dtype=float32``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.parallel import mesh
from object_detectors_tpu_torch.parallel.batch_norm import global_batch_norm


@contextlib.contextmanager
def tf32_off():
    """Full f32 matmuls and convolutions on the GPU (TF32 off for cuBLAS and
    cuDNN) inside the block, the earlier settings restored after it."""
    allow = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow


class ConvBN(nn.Module):
    """conv + batch norm (eps 1e-5) + leaky_relu(0.1): the 'CBL' block.
    Padding is (k-1)//2 on every side, also at stride 2, as in the Flax
    module.

    ``train=False`` normalizes with the running statistics. ``train=True``
    is Flax's ``BatchNorm(use_running_average=False, momentum=0.9)``: it
    normalizes with the batch mean and the biased batch variance, both in
    float32 whatever the activation dtype, and moves the running statistics
    by 0.1 toward them, the running variance toward the biased variance
    (PyTorch's own update takes the unbiased one, n / (n - 1) larger).
    Above one process the statistics are those of the global batch
    (``parallel/batch_norm.py``), as under JAX's mesh."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 strides: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel_size, strides,
                              padding=(kernel_size - 1) // 2, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        conv = self.conv
        x = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
        bn = self.bn
        if not train:
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             False, 0.0, bn.eps)
            return F.leaky_relu(x, 0.1)
        if mesh.process_count() > 1:  # the statistics of the global batch
            return F.leaky_relu(global_batch_norm(x, bn), 0.1)
        # the batch statistics come out of the normalization itself (f32 mean
        # and 1 / sqrt(var + eps) of the biased variance); the running
        # statistics are left to the update below
        x, mean, invstd = torch.native_batch_norm(x, bn.weight, bn.bias, None, None, True,
                                                  0.0, bn.eps)
        with torch.no_grad():
            var = invstd.double().pow(-2).sub(bn.eps).clamp(min=0).float()
            bn.running_mean.mul_(0.9).add_(mean, alpha=0.1)
            bn.running_var.mul_(0.9).add_(var, alpha=0.1)
        return F.leaky_relu(x, 0.1)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Run ``conv`` (float32 parameters) in the dtype of its input."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, conv.stride, conv.padding)


def conv_transpose2d(x: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
    """Run ``conv`` (float32 parameters) in the dtype of its input."""
    return F.conv_transpose2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride,
                              conv.padding)


def linear(x: torch.Tensor, fc: nn.Linear) -> torch.Tensor:
    """Run ``fc`` (float32 parameters) in the dtype of its input."""
    return F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))


class FrozenBatchNorm(nn.Module):
    """Batch norm with fixed statistics (torchvision FrozenBatchNorm2d), as
    the Flax module computes it: scale = weight / sqrt(var + eps) and
    shift = bias - mean * scale in float32, then x * scale + shift in the
    input's dtype. The four tensors are buffers named as the Flax
    ``frozen`` collection names them."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def max_pool_same(x: torch.Tensor, window: int, stride: int = 1) -> torch.Tensor:
    """MaxPool2d(window, stride, padding=(window-1)//2) on NCHW: the padding
    takes no part in the max, as the Flax version's -inf padding."""
    return F.max_pool2d(x, window, stride, (window - 1) // 2)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """The 3x3, stride-2, pad-1 max pool of the ResNet stem on NCHW: the
    JAX function of this name, which computes it by a phase decomposition
    on even sizes and as ``max_pool_same`` on odd ones; both are this
    function, the padding taking no part in the max."""
    return F.max_pool2d(x, 3, 2, 1)


class ClassAttention(nn.Module):
    """SE-style class-logit attention (the JAX ``ClassAttention``, unused on
    the main path): the class logits [B, ..., C] averaged over everything
    but the batch, softmax, ``fc1`` to ``reduction_ratio`` + ReLU, ``fc2``
    back to C, sigmoid -> per-class gates [B, C] in the input's dtype."""

    def __init__(self, num_classes: int, reduction_ratio: int = 16):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = nn.Linear(num_classes, reduction_ratio)
        self.fc2 = nn.Linear(reduction_ratio, num_classes)

    def forward(self, class_logits: torch.Tensor) -> torch.Tensor:
        pooled = class_logits.reshape(class_logits.shape[0], -1, self.num_classes).mean(1)
        x = F.relu(linear(torch.softmax(pooled, -1), self.fc1))
        return torch.sigmoid(linear(x, self.fc2))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='nearest') on NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
