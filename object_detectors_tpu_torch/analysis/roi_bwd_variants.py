"""The RoIAlign backward kernel against variants of itself on one GPU.

    python -m object_detectors_tpu_torch.analysis.roi_bwd_variants [--rounds 6] [--iters 20]

A variant is ``csrc/roi_align.cu`` with some of its ``constexpr int``
constants set to other values, built with the package's nvcc flags into
``_build/variants/``:

* ``shipped``: the source as it is;
* ``staged_only`` (``kBwdDirect = 0``): every RoI takes the staged route,
  none the direct one.

Each runs through ``multiscale_roi_align_backward_cuda`` on the same inputs,
an f32 and a bf16 cotangent [2, 512, 7, 7, 256] on P2-P5 of an 800² image
with RoIs:

* ``synthetic``: chip_smoke.py's training case (its ``random_rois``, seed 0:
  half the boxes under 8 px, the others up to 408 px);
* ``tiny``: every box under 4 px (a few footprint pixels each, all staged);
* ``large``: boxes of 200-800 px (bins of 2 pixels and more on their
  level, the direct route's case).

Every variant's output is first held against the shipped kernel's (f32
within 1e-4 relative and 1e-5 times the largest value absolute, bf16 within
one bf16 ulp of max(|shipped|, 1)). Then, for ``--rounds`` rounds, the
variants run in turn, in reverse order every other round, each timed as
the kernel's device time from a torch.profiler trace of ``--iters`` calls.
Prints one JSON line: the card's name and power limit, and for each input
and variant the median over rounds and the spread (max - min) in ms. Needs
a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from object_detectors_tpu_torch.kernels import _build
from object_detectors_tpu_torch.kernels import roi_align_bwd as KB

VARIANTS = {"shipped": {}, "staged_only": {"kBwdDirect": 0}}
SIZE = 800


def variant_source(sets: dict) -> str:
    src = (_build.CSRC_DIR / "roi_align.cu").read_text()
    for name, value in sets.items():
        src, hits = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                            src)
        if hits != 1:
            raise ValueError(f"{name} is not one constexpr int of roi_align.cu")
    return src


def build_variant(sets: dict):
    """The variant's ``roi_align_backward``, its argument types the wrapper's."""
    src = variant_source(sets)
    key = hashlib.sha256((src + " ".join(_build.NVCC_FLAGS)).encode()).hexdigest()[:16]
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"libroi_align-{key}.so"
    if not lib.exists():
        cu = out_dir / f"roi_align-{key}.cu"
        cu.write_text(src)
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sets}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).roi_align_backward
    fn.argtypes, fn.restype = KB._function().argtypes, ctypes.c_int
    return fn


def boxes_of(kind: str, n: int = 512) -> torch.Tensor:
    rng = np.random.RandomState(0)
    if kind == "synthetic":  # chip_smoke.py:random_rois(0, 2, n, SIZE)
        xy = rng.rand(2, n, 2) * (SIZE - 30)
        wh = rng.rand(2, n, 2) * ((rng.rand(2, n, 1) > 0.5) * SIZE / 2 + 8)
    else:
        lo, hi = {"tiny": (0.2, 4.0), "large": (200.0, 800.0)}[kind]
        wh = lo + rng.rand(2, n, 2) * (hi - lo)
        xy = rng.rand(2, n, 2) * (SIZE - wh)
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).cuda()


def kernel_ms(call, iters: int) -> float:
    """The backward kernel's mean device time over iters calls."""
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    total = sum(e.device_time for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "roi_align_backward_kernel" in e.name)
    if total <= 0:
        raise RuntimeError("the trace holds no roi_align_backward_kernel")
    return total / 1e3 / iters


def agrees(got, ref, dtype) -> bool:
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            tol = 1e-5 * max(1.0, float(r.abs().max())) + 1e-4 * r.abs()
        else:
            tol = (r.abs().clamp(min=1.0).log2().floor() - 7).exp2()
        if not bool(((g - r).abs() <= tol).all()):
            return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    shipped = KB._function
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        fns = dict(zip(VARIANTS, pool.map(build_variant, VARIANTS.values())))
    shapes = [(2, 256, SIZE // s, SIZE // s) for s in (4, 8, 16, 32)]
    g = torch.Generator(device="cuda").manual_seed(0)
    cot32 = torch.randn(2, 512, 7, 7, 256, generator=g, device="cuda")
    result = {}
    try:
        for kind in ("synthetic", "tiny", "large"):
            boxes = boxes_of(kind)
            for dtype in (torch.float32, torch.bfloat16):
                cot = cot32.to(dtype)

                def call(name):
                    KB._function = lambda: fns[name]
                    return KB.multiscale_roi_align_backward_cuda(cot, boxes, shapes, (SIZE, SIZE),
                                                                 dtype=dtype)

                ref = call("shipped")
                for name in VARIANTS:
                    if not agrees(call(name), ref, dtype):
                        raise AssertionError(f"{name} disagrees with the shipped kernel "
                                             f"({kind}, {dtype})")
                times = {name: [] for name in VARIANTS}
                for r in range(args.rounds):
                    order = list(VARIANTS) if r % 2 == 0 else list(VARIANTS)[::-1]
                    for name in order:
                        times[name].append(kernel_ms(lambda: call(name), args.iters))
                result[f"{kind} {dtype}"] = {
                    name: {"median_ms": float(np.median(t)), "spread_ms": max(t) - min(t)}
                    for name, t in times.items()}
    finally:
        KB._function = shipped
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"card": card, "variants": VARIANTS, "kernel_ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
