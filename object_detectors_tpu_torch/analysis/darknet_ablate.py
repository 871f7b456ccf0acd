"""Darknet-53 stage ablation on one GPU (port of the JAX package's
``analysis/darknet_ablate.py``).

    python -m object_detectors_tpu_torch.analysis.darknet_ablate [--bs 64]
        [--size 640] [--iters 12] [--device cpu]

A stem-only row, then the cumulative prefixes through the first 1 to 5
Darknet-53 stages (``Prefix``: the port's ``ConvBN`` and ``ResidualBlock``
under the Flax prefix's names, seeded weights), on one seeded float batch in
bf16 (the input is float, so the normalize kernel is not on this path).
Each prefix is timed with back-to-back calls and one synchronization at the
end (``yolo_stages.time_calls``). Prints one JSON line: the card's name and
power limit, each prefix's ms, its marginal over the prefix before and its
images/s.

The JAX timer has no TPU-only variant; all its rows are ported.
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.yolo_stages import prefix_times, timer_line
from object_detectors_tpu_torch.models.darknet import DarkNet
from object_detectors_tpu_torch.models.yolo import init_yolo_


class Prefix(DarkNet):
    """The stem and the first ``n_stages`` Darknet stages; NHWC images in,
    the last stage's NCHW map out."""

    def __init__(self, n_stages: int, layers: Sequence[int] = (1, 2, 8, 8, 4)):
        super().__init__(tuple(layers)[:n_stages])

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = self.stem(x, train)
        for stage, blocks in enumerate(self.layers):
            x = getattr(self, f"down{stage + 1}")(x, train)
            for i in range(blocks):
                x = getattr(self, f"stage{stage + 1}_block{i}")(x, train)
        return x


def build_stages(device="cuda"):
    """{"stem", "+stage1", ..., "+stage5"}: each Darknet-53 prefix's forward
    in eval (seeded weights, seed 0)."""
    return {"stem" if n == 0 else f"+stage{n}": init_yolo_(Prefix(n)).to(device).eval()
            for n in range(6)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(args.bs, args.size, args.size, 3).astype(np.float32)
                              ).to(dev, torch.bfloat16)
    with torch.inference_mode():
        ms, marginal = prefix_times(build_stages(dev), images,
                                    iters=args.iters, device=dev)
    return timer_line("darknet_ablate", dev, bs=args.bs, size=args.size, dtype="bfloat16",
                      iters=args.iters, stage_ms=ms, marginal_ms=marginal,
                      img_per_s={k: args.bs / v * 1e3 for k, v in ms.items()})


if __name__ == "__main__":
    main()
