"""ResNet backbone and the FPN on top (port of the JAX package's
``models/resnet.py``): the torchvision v1.5 Bottleneck (the stride sits on
the 3x3 conv) of ResNet-50, and the BasicBlock of ResNet-18 and -34
(``block="basic"``).

``norm`` is the JAX ``_norm``: "frozen" (FrozenBatchNorm, the detection
backbones) or "bn", a batch norm with trainable scale and bias (momentum 0.1
in PyTorch's sense, Flax's 0.9; eps 1e-5) that, as the JAX module built with
``use_running_average=True``, normalizes with its running statistics in
training mode too and never moves them. As in JAX, block 0 of every stage
has the projection (``down_conv``, ``down_bn``), for the basic block too.
``trainable_mask`` is the JAX function of the same name, over the
parameter names.

The stem is the plain composition conv1 7x7/s2 -> norm -> ReLU -> 3x3/s2
max pool; the JAX package computes the same function in a phase-split
layout for the TPU, which is not ported. Submodule names follow the Flax
module names (``conv1``, ``bn1``, ``layer{s}_block{i}`` with ``conv1..3``,
``bn1..3``, ``down_conv``, ``down_bn``; ``resnet`` and ``fpn`` under the
backbone), so converted weights load by path.

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
from object_detectors_tpu_torch.models.common import FrozenBatchNorm, conv2d, max_pool_same
from object_detectors_tpu_torch.models.fpn import FeaturePyramidNetwork

FUSED_MODES = ("off", "auto", "interpret")
NORMS = ("frozen", "bn")


class RunningBatchNorm(nn.BatchNorm2d):
    """The JAX ``_norm(kind="bn")``: ``nn.BatchNorm(use_running_average=True,
    momentum=0.9, epsilon=1e-5)``, which normalizes with the running
    statistics in either mode and never updates them; its scale and bias
    train."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _norm(features: int, kind: str) -> nn.Module:
    if kind not in NORMS:
        raise ValueError(f"norm must be one of {NORMS}, got {kind!r}")
    return FrozenBatchNorm(features) if kind == "frozen" else RunningBatchNorm(features)


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
                 downsample: bool = False, fused: str = "off", norm: str = "frozen"):
        super().__init__()
        if fused not in FUSED_MODES:
            raise ValueError(f"fused must be one of {FUSED_MODES}, got {fused!r}")
        self.fused = fused
        self.norm = norm
        self.stride = stride
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(in_features, planes, 1, bias=False)
        self.bn1 = _norm(planes, norm)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = _norm(planes, norm)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = _norm(out, norm)
        self.downsample = downsample
        if downsample:
            self.down_conv = nn.Conv2d(in_features, out, 1, stride, bias=False)
            self.down_bn = _norm(out, norm)
        self._prepared = None  # (key, PreparedBlock): see prepared()

    def uses_fused(self, x: torch.Tensor) -> bool:
        """The JAX gate: eval, stride 1, frozen batch norm, bf16 input, even
        height; "auto" only on a CUDA tensor."""
        return (self.fused != "off" and not self.training and self.stride == 1
                and self.norm == "frozen"
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


class BasicBlock(nn.Module):
    """Two 3x3 convs (the stride on the first) with their norms, and the
    projection where ``downsample``."""

    expansion = 1

    def __init__(self, in_features: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm: str = "frozen"):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, planes, 3, stride, padding=1, bias=False)
        self.bn1 = _norm(planes, norm)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _norm(planes, norm)
        self.downsample = downsample
        if downsample:
            self.down_conv = nn.Conv2d(in_features, planes, 1, stride, bias=False)
            self.down_bn = _norm(planes, norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(conv2d(x, self.conv1)))
        out = self.bn2(conv2d(out, self.conv2))
        identity = self.down_bn(conv2d(x, self.down_conv)) if self.downsample else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    """``layers`` (3, 4, 6, 3) with ``block="bottleneck"`` is ResNet-50,
    (2, 2, 2, 2) with ``block="basic"`` ResNet-18. Returns (C2, C3, C4,
    C5). ``fused`` applies to the bottleneck blocks with frozen batch norm
    only."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), fused: str = "off",
                 block: str = "bottleneck", norm: str = "frozen"):
        super().__init__()
        if block not in ("bottleneck", "basic"):
            raise ValueError(f"block must be 'bottleneck' or 'basic', got {block!r}")
        self.block, self.norm = block, norm
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = _norm(64, norm)
        in_features, planes = 64, 64
        self.out_channels = []
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            for i in range(blocks):
                stride_i = stride if i == 0 else 1
                if block == "bottleneck":
                    unit = Bottleneck(in_features, planes, stride_i, downsample=i == 0,
                                      fused=fused, norm=norm)
                else:
                    unit = BasicBlock(in_features, planes, stride_i, downsample=i == 0,
                                      norm=norm)
                self.add_module(f"layer{stage + 1}_block{i}", unit)
                in_features = planes * unit.expansion
            self.out_channels.append(in_features)
            planes *= 2
        self.layers = tuple(layers)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(conv2d(x, self.conv1)))
        x = max_pool_same(x, 3, 2)
        feats = []
        for stage, blocks in enumerate(self.layers):
            for i in range(blocks):
                x = getattr(self, f"layer{stage + 1}_block{i}")(x)
            feats.append(x)
        return tuple(feats)


def resnet18(norm: str = "frozen") -> ResNet:
    return ResNet((2, 2, 2, 2), block="basic", norm=norm)


def trainable_mask(model: nn.Module, trainable_layers: int = 3) -> dict[str, bool]:
    """{parameter name: trains}, the JAX ``trainable_mask`` over the port's
    parameter names: torchvision freezes the first (5 - trainable_layers)
    of [layer4, layer3, layer2, layer1, conv1] and adds bn1 at
    trainable_layers == 5 (backbone_utils.py:84-94). As in JAX, a name is
    tested by substring: one outside "backbone" and "resnet" trains; one
    inside trains when it holds a named layer (the FPN under "backbone"
    holds none)."""
    layers_to_train = ["layer4", "layer3", "layer2", "layer1", "conv1"][:trainable_layers]
    if trainable_layers == 5:
        layers_to_train.append("bn1")

    def trains(name: str) -> bool:
        if "backbone" not in name and "resnet" not in name:
            return True
        return any(layer in name for layer in layers_to_train)

    return {name: trains(name) for name, _ in model.named_parameters()}


def apply_trainable_mask(model: nn.Module, trainable_layers: int = 3) -> dict[str, bool]:
    """Set each parameter's ``requires_grad`` from ``trainable_mask``;
    returns the mask."""
    mask = trainable_mask(model, trainable_layers)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return mask


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
