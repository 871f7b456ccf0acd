"""Feature Pyramid Network with the ``pool`` extra block (port of the JAX
package's ``models/fpn.py``, torchvision FeaturePyramidNetwork semantics):
per-level 1x1 inner convs to a common width, a top-down pathway of nearest
upsampling + add, per-level 3x3 output convs, and P6 as P5 subsampled by 2
(LastLevelMaxPool: a 1x1 max pool with stride 2). Submodule names follow
the Flax module names (``inner{i}``, ``layer{i}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.models.common import conv2d


def upsample_nearest_to(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW ``x`` to ``size`` = (H, W), an exact
    integer multiple of its own; other factors are not ported."""
    h, w = x.shape[-2:]
    th, tw = size
    if (th, tw) == (h, w):
        return x
    if th % h or tw % w:
        raise ValueError(f"FPN upsample from {(h, w)} to {(th, tw)} is not by an "
                         "integer factor; only integer factors are ported")
    return F.interpolate(x, size=(th, tw), mode="nearest")


class FeaturePyramidNetwork(nn.Module):
    """in: NCHW maps fine -> coarse; out: the same number of maps at
    ``out_channels`` width, plus P6 when ``extra_blocks == "pool"``."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 extra_blocks: str | None = "pool"):
        super().__init__()
        if extra_blocks not in (None, "pool"):
            raise ValueError(f"extra block {extra_blocks!r} is not ported")
        self.extra_blocks = extra_blocks
        self.num_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"inner{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"layer{i}", nn.Conv2d(out_channels, out_channels, 3,
                                                   padding=1))

    def forward(self, features: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        inners = [conv2d(f, getattr(self, f"inner{i}")) for i, f in enumerate(features)]
        last = inners[-1]
        laterals = [last]
        for inner in reversed(inners[:-1]):
            last = inner + upsample_nearest_to(last, inner.shape[-2:])
            laterals.insert(0, last)
        outs = [conv2d(x, getattr(self, f"layer{i}")) for i, x in enumerate(laterals)]
        if self.extra_blocks == "pool":
            outs.append(outs[-1][:, :, ::2, ::2])
        return outs
