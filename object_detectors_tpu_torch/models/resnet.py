"""ResNet backbone with frozen batch norm and the FPN on top (port of the
JAX package's ``models/resnet.py``, torchvision v1.5 Bottleneck: the
stride sits on the 3x3 conv).

The stem is the plain composition conv1 7x7/s2 -> FrozenBN -> ReLU ->
3x3/s2 max pool; the JAX package computes the same function in a
phase-split layout for the TPU, which is not ported. Submodule names follow
the Flax module names (``conv1``, ``bn1``, ``layer{s}_block{i}`` with
``conv1..3``, ``bn1..3``, ``down_conv``, ``down_bn``; ``resnet`` and
``fpn`` under the backbone), so converted weights load by path.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.models.common import FrozenBatchNorm, conv2d
from object_detectors_tpu_torch.models.fpn import FeaturePyramidNetwork


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(conv2d(x, self.conv1)))
        out = F.relu(self.bn2(conv2d(out, self.conv2)))
        out = self.bn3(conv2d(out, self.conv3))
        identity = self.down_bn(conv2d(x, self.down_conv)) if self.downsample else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Bottleneck ResNet; ``layers`` (3, 4, 6, 3) is ResNet-50. Returns
    (C2, C3, C4, C5)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_features, planes = 64, 64
        self.out_channels = []
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            for i in range(blocks):
                self.add_module(f"layer{stage + 1}_block{i}", Bottleneck(
                    in_features, planes, stride if i == 0 else 1, downsample=i == 0))
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


class BackboneWithFPN(nn.Module):
    """ResNet -> FPN over C2..C5 with the pool extra block: P2..P6."""

    def __init__(self, resnet: ResNet, out_channels: int = 256):
        super().__init__()
        self.resnet = resnet
        self.fpn = FeaturePyramidNetwork(resnet.out_channels, out_channels, "pool")

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.fpn(self.resnet(x))
