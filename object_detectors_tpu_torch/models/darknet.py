"""Darknet-53 backbone (port of the JAX package's ``models/darknet.py``).

A 3x3 stem to 32 channels, then five stages of (stride-2 3x3 downsample +
N residual blocks of 1x1-halve / 3x3-restore), returning C3/C4/C5 (256 /
512 / 1024 channels at strides 8 / 16 / 32). Submodule names follow the
Flax module names, so converted Flax weights load by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from object_detectors_tpu_torch.models.common import ConvBN


class ResidualBlock(nn.Module):
    """1x1 bottleneck to planes[0], 3x3 back to planes[1], + identity."""

    def __init__(self, planes: Sequence[int]):
        super().__init__()
        self.conv1 = ConvBN(planes[1], planes[0], 1)
        self.conv2 = ConvBN(planes[0], planes[1], 3)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.conv2(self.conv1(x, train), train) + x


class DarkNet(nn.Module):
    """Stage layout (1, 2, 8, 8, 4) = Darknet-53; (1, 1, 2, 2, 1) = Darknet-21."""

    # channel plan per stage: (bottleneck, out)
    STAGE_PLANES = ((32, 64), (64, 128), (128, 256), (256, 512), (512, 1024))
    out_channels = (256, 512, 1024)  # C3, C4, C5

    def __init__(self, layers: Sequence[int]):
        super().__init__()
        self.layers = tuple(layers)
        self.stem = ConvBN(3, 32, 3)
        prev = 32
        for stage, (planes, blocks) in enumerate(zip(self.STAGE_PLANES, self.layers)):
            self.add_module(f"down{stage + 1}", ConvBN(prev, planes[1], 3, strides=2))
            for i in range(blocks):
                self.add_module(f"stage{stage + 1}_block{i}", ResidualBlock(planes))
            prev = planes[1]

    def forward(self, x: torch.Tensor, train: bool = False):
        """``train``: batch norm with the batch statistics (``ConvBN``)."""
        x = self.stem(x, train)
        feats = []
        for stage, blocks in enumerate(self.layers):
            x = getattr(self, f"down{stage + 1}")(x, train)
            for i in range(blocks):
                x = getattr(self, f"stage{stage + 1}_block{i}")(x, train)
            if stage >= 2:  # C3, C4, C5
                feats.append(x)
        return tuple(feats)


def darknet53() -> DarkNet:
    return DarkNet(layers=(1, 2, 8, 8, 4))


def darknet21() -> DarkNet:
    return DarkNet(layers=(1, 1, 2, 2, 1))
