"""Multiscale RoIAlign micro-benchmark on one GPU (port of the JAX
package's ``analysis/roialign_bench.py``).

    python -m object_detectors_tpu_torch.analysis.roialign_bench [--bs 8]
        [--rois 1000] [--size 640] [--ch 256] [--variants ...] [--iters 20]
        [--device cpu]

The Faster R-CNN eval shape: ``--bs`` x ``--rois`` seeded RoIs (corners
in the image, sides 8 to 308 px) on the four FPN maps P2-P5 of a
``--size``² image with ``--ch`` channels (seeded normal values), 7x7
bins, sampling ratio 2, in bf16 and in f32. Variants:

* ``noop``: one tiny reduction of the boxes, the floor of a call and one
  synchronization (subtract it from the others);
* ``plain_bf16`` / ``plain_f32``: the plain PyTorch version on the device
  (``kernels.roi_align.multiscale_roi_align_reference``);
* ``kernel_bf16`` / ``kernel_f32``: the pooler (``ops.roi_align.
  pool_multiscale``), the RoIAlign kernel (``csrc/roi_align.cu``) on a CUDA
  device, held against ``plain`` before it is timed: f32 within
  rtol 1e-4 / atol 1e-5 (the same samples and weights summed in another
  order), bf16 within one bf16 ulp (rtol 2^-7) and atol 1e-5.

Each variant is timed with back-to-back calls and one synchronization at
the end (``yolo_stages.time_calls``). Prints one JSON line: the card's
name and power limit, each variant's ms and millions of RoIs a second,
the kernel's largest difference from ``plain`` per dtype and its
launches.

Left out, TPU-only: ``flat``, ``canvas``, ``pallas``, ``pallas_mm2``,
``pallas_dma``, ``pallas_compute``, ``hybrid``, ``tiled``, ``tiled_mm2``,
``tiled_dma``, ``hybrid_tiled``, ``bands``, ``bands_dma``,
``bands_compute``, ``hybrid_bands``, ``grouped`` and its ``rows``, ``a16``,
``wide``, ``dma`` and ``compute`` modes, ``hybrid_grouped``,
``prep_bands`` and ``prep_grouped``: the TPU pooler implementations,
their window tiers and their ``@dma_only`` / ``@compute_only`` /
``@xalign`` debug modes (``ROADMAP.md`` ground rules: the RoIAlign window
tiers and the measured-loser A/B knobs are not ported; the port has one
kernel and its plain version).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.yolo_stages import time_calls, timer_line
from object_detectors_tpu_torch.kernels import roi_align as KR
from object_detectors_tpu_torch.ops.roi_align import pool_multiscale

TOLERANCE = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0 ** -7, 1e-5)}  # rtol, atol


def make_inputs(bs: int, rois: int, size: int, ch: int, device="cuda"):
    """Seeded f32 level maps [bs, ch, size/s, size/s] (channels_last) for
    s = 4, 8, 16, 32 and boxes [bs, rois, 4], drawn as the JAX timer draws
    them."""
    rng = np.random.RandomState(0)
    maps = [torch.from_numpy(rng.randn(bs, size // st, size // st, ch).astype(np.float32))
            .to(device).permute(0, 3, 1, 2) for st in (4, 8, 16, 32)]
    xy = rng.rand(bs, rois, 2) * (size - 40)
    wh = rng.rand(bs, rois, 2) * 300 + 8
    boxes = np.clip(np.concatenate([xy, xy + wh], -1), 0, size).astype(np.float32)
    return maps, torch.from_numpy(boxes).to(device)


def kernel_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |out - ref|; raises where it passes the dtype's
    tolerance."""
    rtol, atol = TOLERANCE[out.dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    return float((out.float() - ref.float()).abs().max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--rois", type=int, default=1000)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--ch", type=int, default=256)
    ap.add_argument("--variants", nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    maps32, boxes = make_inputs(args.bs, args.rois, args.size, args.ch, dev)
    img = (args.size, args.size)
    variants = {"noop": (lambda: boxes.sum())}
    errors = {}
    launches = KR.launches
    with torch.inference_mode():
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            maps = [m.to(dtype) for m in maps32]
            variants[f"plain_{name}"] = (
                lambda maps=maps: KR.multiscale_roi_align_reference(maps, boxes, img))
            variants[f"kernel_{name}"] = (
                lambda maps=maps: pool_multiscale(maps, boxes, img))
            if not args.variants or f"kernel_{name}" in args.variants:
                errors[name] = kernel_error(pool_multiscale(maps, boxes, img),
                                            KR.multiscale_roi_align_reference(maps, boxes,
                                                                              img))
        ms = {name: time_calls(fn, iters=args.iters, device=dev) * 1e3
              for name, fn in variants.items()
              if not args.variants or name in args.variants}
    return timer_line("roialign_bench", dev, bs=args.bs, rois=args.rois, size=args.size,
                      ch=args.ch, iters=args.iters, variant_ms=ms,
                      mrois_per_s={k: args.bs * args.rois / v / 1e3 for k, v in ms.items()},
                      kernel_max_abs_err=errors, roi_align_launches=KR.launches - launches)


if __name__ == "__main__":
    main()
