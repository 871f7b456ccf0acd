"""ResNet backbone with frozen batch norm and the FPN on top (port of the
JAX package's ``models/resnet.py``, torchvision v1.5 Bottleneck: the
stride sits on the 3x3 conv).

The stem is the plain composition conv1 7x7/s2 -> FrozenBN -> ReLU ->
3x3/s2 max pool; the JAX package computes the same function in a
phase-split layout for the TPU, which is not ported. Submodule names follow
the Flax module names (``conv1``, ``bn1``, ``layer{s}_block{i}`` with
``conv1..3``, ``bn1..3``, ``down_conv``, ``down_bn``; ``resnet`` and
``fpn`` under the backbone), so converted weights load by path.

``fused`` ("off", "auto", "interpret") is the JAX knob of the same name: a
stride-1 block in eval with a bf16 input of even height runs as one fused
bottleneck (``kernels/fused_block.py``) with the batch norm folded into its
weights once per parameter version: the folded weights, in the kernel's
layout with their TMA descriptors once a CUDA launch has needed them, are
cached on the block and rebuilt when a convolution weight or a FrozenBN
buffer is replaced, moved or changed in place (the JAX module folds inside
its traced call). "auto" takes the CUDA kernel for a CUDA tensor and the
unfused path on the CPU, as the JAX "auto" fires only on its accelerator;
"interpret" takes the kernel's plain version on any device.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.kernels.fused_block import (
    PreparedBlock, fold_bn, fused_block_cuda, fused_bottleneck_reference,
)
from object_detectors_tpu_torch.models.common import FrozenBatchNorm, conv2d
from object_detectors_tpu_torch.models.fpn import FeaturePyramidNetwork

FUSED_MODES = ("off", "auto", "interpret")


def _version(t: torch.Tensor) -> int:
    """The tensor's version counter; an inference tensor has none, and can
    change in place only inside inference mode."""
    try:
        return t._version
    except RuntimeError:
        return -1


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, planes: int, stride: int = 1,
                 downsample: bool = False, fused: str = "off"):
        super().__init__()
        if fused not in FUSED_MODES:
            raise ValueError(f"fused must be one of {FUSED_MODES}, got {fused!r}")
        self.fused = fused
        self.stride = stride
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(in_features, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = downsample
        if downsample:
            self.down_conv = nn.Conv2d(in_features, out, 1, stride, bias=False)
            self.down_bn = FrozenBatchNorm(out)
        self._prepared = None  # (key, PreparedBlock): see prepared()

    def uses_fused(self, x: torch.Tensor) -> bool:
        """The JAX gate: eval, stride 1, bf16 input, even height; "auto"
        only on a CUDA tensor."""
        return (self.fused != "off" and not self.training and self.stride == 1
                and x.dtype == torch.bfloat16 and x.shape[2] % 2 == 0
                and (self.fused == "interpret" or x.is_cuda))

    def _folded_pairs(self):
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)]
        if self.downsample:
            pairs.append((self.down_conv, self.down_bn))
        return pairs

    def _fold_key(self):
        """Identity and version of every tensor the fold reads: a new tensor
        (``.to()``, ``.cuda()``, assignment) changes its pointer, device or
        dtype, an in-place change (``load_state_dict``, ``copy_``) its
        version."""
        key = []
        for conv, bn in self._folded_pairs():
            for t in (conv.weight, *bn._buffers.values()):
                key += (t.data_ptr(), _version(t), t.device, t.dtype)
        return key

    def prepared(self) -> PreparedBlock:
        """The folded weights (``fold_bn``), built once per parameter version
        and kept with their kernel layout."""
        key = self._fold_key()
        if self._prepared is None or self._prepared[0] != key:
            # plain tensors, whatever the caller's mode: a bundle built inside
            # inference_mode serves later calls outside it
            with torch.inference_mode(False), torch.no_grad():
                out = [t.detach() for conv, bn in self._folded_pairs()
                       for t in fold_bn(conv.weight, dict(bn.named_buffers()), bn.eps)]
            self._prepared = (key, PreparedBlock(*out))
        return self._prepared[1]

    def folded(self):
        """(w1, b1, w2, b2, w3, b3, wd, bd): the convolutions with their
        batch norms folded in (``fold_bn``), from the cache of
        ``prepared()``; wd and bd are None without a projection."""
        return list(self.prepared().folded)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.uses_fused(x):
            if self.fused == "interpret":
                return fused_bottleneck_reference(x, *self.folded())
            return fused_block_cuda(x, self.prepared())  # "auto" fuses only on the card
        out = F.relu(self.bn1(conv2d(x, self.conv1)))
        out = F.relu(self.bn2(conv2d(out, self.conv2)))
        out = self.bn3(conv2d(out, self.conv3))
        identity = self.down_bn(conv2d(x, self.down_conv)) if self.downsample else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Bottleneck ResNet; ``layers`` (3, 4, 6, 3) is ResNet-50. Returns
    (C2, C3, C4, C5)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), fused: str = "off"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_features, planes = 64, 64
        self.out_channels = []
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            for i in range(blocks):
                self.add_module(f"layer{stage + 1}_block{i}", Bottleneck(
                    in_features, planes, stride if i == 0 else 1, downsample=i == 0,
                    fused=fused))
                in_features = planes * Bottleneck.expansion
            self.out_channels.append(in_features)
            planes *= 2
        self.layers = tuple(layers)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(conv2d(x, self.conv1)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for stage, blocks in enumerate(self.layers):
            for i in range(blocks):
                x = getattr(self, f"layer{stage + 1}_block{i}")(x)
            feats.append(x)
        return tuple(feats)


def set_fused(module: nn.Module, mode: str) -> None:
    """Set the ``fused`` mode of every Bottleneck under ``module``."""
    if mode not in FUSED_MODES:
        raise ValueError(f"fused must be one of {FUSED_MODES}, got {mode!r}")
    for m in module.modules():
        if isinstance(m, Bottleneck):
            m.fused = mode


class BackboneWithFPN(nn.Module):
    """ResNet -> FPN over ``returned_layers`` (1-based stages): with the
    ``pool`` extra block over C2..C5 (P2..P6, Faster R-CNN), with ``p6p7``
    over C3..C5 (P3..P7, RetinaNet), unless given."""

    def __init__(self, resnet: ResNet, out_channels: int = 256, extra_blocks: str = "pool",
                 returned_layers: Sequence[int] | None = None):
        super().__init__()
        self.resnet = resnet
        self.returned_layers = tuple(returned_layers or (
            (1, 2, 3, 4) if extra_blocks == "pool" else (2, 3, 4)))
        self.fpn = FeaturePyramidNetwork(
            [resnet.out_channels[i - 1] for i in self.returned_layers], out_channels,
            extra_blocks)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = self.resnet(x)
        return self.fpn([feats[i - 1] for i in self.returned_layers])
