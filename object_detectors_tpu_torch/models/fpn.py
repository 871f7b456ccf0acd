"""Feature Pyramid Network (port of the JAX package's ``models/fpn.py``,
torchvision FeaturePyramidNetwork semantics): per-level 1x1 inner convs to a
common width, a top-down pathway of nearest upsampling + add, per-level 3x3
output convs, and an extra block: ``pool`` (Faster R-CNN) appends P6 as P5
subsampled by 2 (LastLevelMaxPool: a 1x1 max pool with stride 2); ``p6p7``
(RetinaNet, LastLevelP6P7 fed from P5) appends P6 = 3x3/s2 conv of P5 and
P7 = 3x3/s2 conv of relu(P6), both with padding 1; with
``p6p7_in_from_c5`` P6 is taken from the ``c5`` map given to ``forward``,
as wide as the last input (the original paper's variant; the P5 one is the
reference's). Submodule
names follow the Flax module names
(``inner{i}``, ``layer{i}``, ``p6``, ``p7``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from object_detectors_tpu_torch.models.common import conv2d


def upsample_nearest_to(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW ``x`` to ``size`` = (H, W), as the
    JAX ``_upsample_nearest_to``: at any factor, source index floor((i +
    0.5) * in / out), which ``jax.image.resize(..., "nearest")`` and
    ``mode="nearest-exact"`` share (``mode="nearest"`` takes floor(i * in /
    out) and differs at factors that are not integers)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


class FeaturePyramidNetwork(nn.Module):
    """in: NCHW maps fine -> coarse; out: the same number of maps at
    ``out_channels`` width, plus P6 (``pool``) or P6 and P7 (``p6p7``)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 extra_blocks: str | None = "pool", p6p7_in_from_c5: bool = False):
        super().__init__()
        if extra_blocks not in (None, "pool", "p6p7"):
            raise ValueError(f"extra block {extra_blocks!r} is not ported")
        self.extra_blocks = extra_blocks
        self.num_levels = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"inner{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"layer{i}", nn.Conv2d(out_channels, out_channels, 3,
                                                   padding=1))
        self.p6p7_in_from_c5 = p6p7_in_from_c5
        if extra_blocks == "p6p7":
            p6_in = in_channels[-1] if p6p7_in_from_c5 else out_channels
            self.p6 = nn.Conv2d(p6_in, out_channels, 3, 2, padding=1)
            self.p7 = nn.Conv2d(out_channels, out_channels, 3, 2, padding=1)

    def forward(self, features: Sequence[torch.Tensor], c5: torch.Tensor | None = None
                ) -> list[torch.Tensor]:
        inners = [conv2d(f, getattr(self, f"inner{i}")) for i, f in enumerate(features)]
        last = inners[-1]
        laterals = [last]
        for inner in reversed(inners[:-1]):
            last = inner + upsample_nearest_to(last, inner.shape[-2:])
            laterals.insert(0, last)
        outs = [conv2d(x, getattr(self, f"layer{i}")) for i, x in enumerate(laterals)]
        if self.extra_blocks == "pool":
            outs.append(outs[-1][:, :, ::2, ::2])
        elif self.extra_blocks == "p6p7":
            if self.p6p7_in_from_c5 and c5 is None:
                raise ValueError("p6p7_in_from_c5 takes P6 from the c5 argument")
            p6 = conv2d(c5 if self.p6p7_in_from_c5 else outs[-1], self.p6)
            outs += [p6, conv2d(F.relu(p6), self.p7)]
        return outs
