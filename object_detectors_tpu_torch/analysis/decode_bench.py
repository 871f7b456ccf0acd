"""RetinaNet post-cap decode micro-benchmark on one GPU (port of the JAX
package's ``analysis/decode_bench.py``).

    python -m object_detectors_tpu_torch.analysis.decode_bench [--bs 16]
        [--size 640] [--iters 20] [--device cpu]

Three formulations of the capped survivors' boxes, from seeded anchor
indices ``aidx`` [B, 2000], the box regression ``reg`` [B, A, 4] in bf16
and the anchor table [A, 4] of a ``--size``² image (RetinaNet's 9 anchors a
cell at strides 8 to 128), each decoded (``ops.boxes.decode_boxes``,
weights 1) and clipped:

* ``fused``: the deltas (as f32) and the anchors in one [A, 8] f32 table,
  one gather;
* ``split``: two gathers, the bf16 delta rows and the f32 anchor rows (the
  port's ``retinanet.decode_candidates``);
* ``arith``: one gather of the delta rows; the anchor rows rebuilt from the
  index (``anchors_from_index`` over ``level_layout``): col * stride +
  the level's rounded base row, integer products exact in f32.

The rebuilt anchors must equal the table's rows bitwise, and the three
formulations' boxes bitwise; a difference raises. The base row is indexed
from its [L * A, 4] table: the JAX timer contracts a one-hot with it,
which a GPU matrix product under TF32 (on in the detection paths) would
round. Each formulation is timed with back-to-back calls and one
synchronization at the end (``yolo_stages.time_calls``). Prints one JSON
line: the card's name and power limit, each formulation's ms and
images/s, and the mismatches.

The JAX timer has no TPU-only variant; all three are ported.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.yolo_stages import time_calls, timer_line
from object_detectors_tpu_torch.models import anchors as anchor_lib
from object_detectors_tpu_torch.ops.boxes import clip_boxes_to_image, decode_boxes
from object_detectors_tpu_torch.ops.nms import gather_rows

NCAP = 2000
STRIDES = (8, 16, 32, 64, 128)


def level_layout(size: int = 640, device="cpu"):
    """(anchor table [A, 4], base rows [L, A_cell, 4], anchors a cell, each
    level's first index, grid widths, strides) of RetinaNet at ``size``²."""
    grids = [(size // s,) * 2 for s in STRIDES]
    sizes, ratios = anchor_lib.retinanet_anchor_config()
    anchors = torch.from_numpy(anchor_lib.grid_anchors((size, size), grids, sizes, ratios))
    bases = torch.from_numpy(np.stack([anchor_lib.cell_anchors(s, a)
                                       for s, a in zip(sizes, ratios)]).astype(np.float32))
    a_per = bases.shape[1]
    level_sizes = [gh * gw * a_per for gh, gw in grids]
    starts = [int(s) for s in np.concatenate([[0], np.cumsum(level_sizes)])[:-1]]
    return (anchors.to(device), bases.to(device), a_per, starts, [g[1] for g in grids],
            list(STRIDES))


def anchors_from_index(aidx: torch.Tensor, bases: torch.Tensor, a_per: int, starts, gws,
                       strides) -> torch.Tensor:
    """The anchor table's rows at global indices ``aidx`` [...], rebuilt:
    the same f32 values (products of integers below 2^24, plus the level's
    rounded base row, indexed from its [L * A_cell, 4] table)."""
    aidx = aidx.long()
    lvl = torch.zeros_like(aidx)
    start = torch.zeros_like(aidx)
    gw = torch.zeros_like(aidx)
    stride = torch.zeros_like(aidx)
    for li, (s0, g, st) in enumerate(zip(starts, gws, strides)):
        sel = aidx >= s0
        lvl = torch.where(sel, li, lvl)
        start = torch.where(sel, s0, start)
        gw = torch.where(sel, g, gw)
        stride = torch.where(sel, st, stride)
    local = aidx - start
    cell = local // a_per
    row = (cell // gw).float()
    col = (cell % gw).float()
    st_f = stride.float()
    sx = col * st_f
    sy = row * st_f
    base = bases.reshape(-1, 4)[lvl * a_per + local % a_per]
    return torch.stack([sx, sy, sx, sy], -1) + base


def formulations(anchors, bases, a_per, starts, gws, strides, size: int) -> dict:
    """{name: fn(reg [B, A, 4], aidx [B, N]) -> boxes [B, N, 4]}."""
    def decode(r, an):
        return clip_boxes_to_image(decode_boxes(r, an), (size, size))

    def fused(reg, aidx):
        table = torch.cat([reg.float(), anchors.expand(reg.shape[0], -1, -1)], -1)
        ra = gather_rows(table, aidx)
        return decode(ra[..., :4], ra[..., 4:])

    def split(reg, aidx):
        return decode(gather_rows(reg, aidx).float(), anchors[aidx])

    def arith(reg, aidx):
        return decode(gather_rows(reg, aidx).float(),
                      anchors_from_index(aidx, bases, a_per, starts, gws, strides))

    return {"fused": fused, "split": split, "arith": arith}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    layout = level_layout(args.size, dev)
    anchors = layout[0]
    a_total = anchors.shape[0]
    rng = np.random.RandomState(0)
    reg = torch.from_numpy(rng.randn(args.bs, a_total, 4).astype(np.float32)).to(
        dev, torch.bfloat16)
    aidx = torch.from_numpy(rng.randint(0, a_total, (args.bs, NCAP))).to(dev)
    fns = formulations(*layout, args.size)
    with torch.inference_mode():
        rebuilt = anchors_from_index(aidx, *layout[1:])
        anchor_mismatches = int((rebuilt != anchors[aidx]).sum())
        outs = {name: fn(reg, aidx) for name, fn in fns.items()}
        box_mismatches = {name: int((out != outs["fused"]).sum()) for name, out in outs.items()}
        ms = {name: time_calls(fn, reg, aidx, iters=args.iters, device=dev) * 1e3
              for name, fn in fns.items()}
    if anchor_mismatches or any(box_mismatches.values()):
        raise AssertionError(f"decode_bench: {anchor_mismatches} anchor and "
                             f"{box_mismatches} box mismatches")
    return timer_line("decode_bench", dev, bs=args.bs, size=args.size, ncap=NCAP,
                      iters=args.iters, variant_ms=ms,
                      img_per_s={k: args.bs / v * 1e3 for k, v in ms.items()},
                      anchor_mismatches=anchor_mismatches, box_mismatches=box_mismatches)


if __name__ == "__main__":
    main()
