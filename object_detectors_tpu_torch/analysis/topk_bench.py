"""Exact big-k selection micro-benchmark on one GPU (port of the JAX
package's ``analysis/topk_bench.py``).

    python -m object_detectors_tpu_torch.analysis.topk_bench [--bs 16]
        [--k 1000] [--iters 20] [--device cpu]

Every exact top-k the port has, at the proposal filter's and RetinaNet's
shapes (``--bs`` rows of seeded normal f32 scores: ``rpn_p2`` 76800, the
RPN's finest level at 640²; ``retina_pairs`` 91008, RetinaNet's stage-2
(anchor, class) pairs; ``gathered`` 64000), k = ``--k``:

  topk        torch.topk
  radix       ops.selection.radix_topk (the JAX order: row, value, index)
  radix_bf16  radix_topk of the scores rounded to bf16
  blocked     ops.nms.exact_blocked_topk (block maxima, then a top-k)
  sortsel     a full stable sort and a slice (ops.nms.topk_lowest_index)

Each is timed with back-to-back calls and one synchronization at the end
(``yolo_stages.time_calls``). The f32 variants must select the same index
set (``torch.topk`` promises no order among ties, so only sets are
compared); ``radix`` and ``sortsel`` promise the JAX order, so their index
sets sorted by (value descending, index ascending) must be equal
sequences, and ``radix_bf16`` must select the set ``sortsel`` selects on
the same bf16 scores (ties are common there). A difference raises.
Prints one JSON line: the card's name and power limit and each shape's
variant times.

Left out, TPU-only: ``approx1``, ``lax.approx_max_k`` (a TPU partial
reduction with a recall target; ``ROADMAP.md`` ground rules, "Port the
function, not the TPU layout": it has no counterpart, and the exact
variants above compute the same function).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.yolo_stages import time_calls, timer_line
from object_detectors_tpu_torch.ops.nms import exact_blocked_topk, topk_lowest_index
from object_detectors_tpu_torch.ops.selection import radix_topk

SHAPES = {"rpn_p2": 76800, "retina_pairs": 91008, "gathered": 64000}


def variants(k: int) -> dict:
    """{name: fn(scores [B, n]) -> (values, indices)}."""
    return {"topk": lambda x: torch.topk(x, k, dim=-1),
            "radix": lambda x: radix_topk(x, k),
            "radix_bf16": lambda x: radix_topk(x.to(torch.bfloat16), k),
            "blocked": lambda x: exact_blocked_topk(x, k),
            "sortsel": lambda x: topk_lowest_index(x, k)}


def index_sets(indices: torch.Tensor) -> torch.Tensor:
    return torch.sort(indices.long(), dim=-1).values


def check_selections(x: torch.Tensor, k: int) -> dict:
    """The module docstring's comparisons on scores ``x``; returns
    {variant: selects the reference set}, raising on a difference."""
    v = variants(k)
    ref = index_sets(v["sortsel"](x)[1])
    same = {name: torch.equal(index_sets(v[name](x)[1]), ref)
            for name in ("topk", "radix", "blocked")}
    # radix regroups its set by 128-lane row; in (value, index) order it
    # is sortsel's sequence
    values, idx = v["radix"](x)
    order = torch.sort(idx, dim=-1, stable=True).indices
    order = torch.gather(order, -1, torch.sort(torch.gather(values, -1, order), dim=-1,
                                               descending=True, stable=True).indices)
    same["radix_order"] = torch.equal(torch.gather(idx, -1, order), v["sortsel"](x)[1])
    xb = x.to(torch.bfloat16)
    same["radix_bf16"] = torch.equal(index_sets(v["radix_bf16"](x)[1]),
                                     index_sets(topk_lowest_index(xb, k)[1]))
    if not all(same.values()):
        raise AssertionError(f"topk_bench: the selections differ: {same}")
    return same


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.RandomState(0)
    ms, checks = {}, {}
    with torch.inference_mode():
        for name, n in SHAPES.items():
            x = torch.from_numpy(rng.randn(args.bs, n).astype(np.float32)).to(dev)
            checks[name] = check_selections(x, args.k)
            ms[name] = {vname: time_calls(fn, x, iters=args.iters, device=dev) * 1e3
                        for vname, fn in variants(args.k).items()}
    return timer_line("topk_bench", dev, bs=args.bs, k=args.k,
                      shapes=SHAPES, iters=args.iters,
                      variant_ms=ms, same_selection=checks)


if __name__ == "__main__":
    main()
