"""RPN proposal-filter stage ablation on one GPU (port of the JAX package's
``analysis/rpnfilter_ablate.py``).

    python -m object_detectors_tpu_torch.analysis.rpnfilter_ablate [--bs 16]
        [--size 640] [--stages ...] [--iters 20] [--device cpu]

The Faster R-CNN proposal filter (``models/rpn.py:filter_proposals``,
``RPNConfig()``'s test settings: 1000 a level, IoU 0.7, 1000 kept) at a
``--size``² image's level sizes (3 anchors a cell at strides 4 to 64) on
seeded proposals and objectness logits, cut into cumulative prefixes of the
filter's own steps: ``topk_only`` (each level's top-k,
``rpn.level_topk``), ``plus_gather`` (+ the gathers of the winners'
boxes, the sigmoid, clip and small-box mask: ``rpn.level_candidates``),
``plus_nms`` (+ the per-level NMS on the NMS kernel, ``csrc/nms.cu``:
``rpn.level_survivors``) and ``full_filter`` (+ the merge top-k:
``filter_proposals`` itself). Each stage is timed with back-to-back calls
and one synchronization at the end (``yolo_stages.time_calls``).

Prints one JSON line: the card's name and power limit, each stage's ms,
its marginal over the stage before, images/s, the NMS launches of one
``full_filter`` call, and whether ``merge_survivors`` of ``plus_nms``'s
output equals ``full_filter`` (a difference raises).

Left out, TPU-only: ``plus_iou``, the [L, pre_n, pre_n] IoU matrices of the
JAX fixed-point NMS loop, which the NMS kernel replaces (``ROADMAP.md``
ground rules, "Port the function, not the TPU layout"); ``plus_nms`` times
the kernel in their place.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.frcnn_ablate import same_detections
from object_detectors_tpu_torch.analysis.yolo_stages import (
    prefix_times, synchronize, timer_line,
)
from object_detectors_tpu_torch.kernels import nms as KN
from object_detectors_tpu_torch.models import rpn as RPN


def level_sizes_of(size: int) -> tuple:
    """Anchors a level of a ``size``² image: 3 a cell at strides 4 to 64."""
    return tuple(3 * (size // st) ** 2 for st in (4, 8, 16, 32, 64))


def make_inputs(bs: int, size: int, device="cuda"):
    """Seeded proposals [bs, A, 4] (xyxy in the image) and objectness
    logits [bs, A], drawn as the JAX timer draws them."""
    a = sum(level_sizes_of(size))
    rng = np.random.RandomState(0)
    props = np.clip(rng.rand(bs, a, 4) * size, 0, size).astype(np.float32)
    props[..., 2:] = props[..., 2:] + props[..., :2]
    obj = rng.randn(bs, a).astype(np.float32)
    return torch.from_numpy(props).to(device), torch.from_numpy(obj).to(device)


def build_stages(level_sizes, image_size, cfg: RPN.RPNConfig = RPN.RPNConfig()):
    """{name: fn(proposals, objectness)}: the module docstring's prefixes."""
    def plus_gather(props, obj):
        return RPN.level_candidates(props, obj, level_sizes, image_size, cfg)

    def plus_nms(props, obj):
        boxes, scores = plus_gather(props, obj)
        return boxes, RPN.level_survivors(boxes, scores, cfg)

    return {"topk_only": lambda props, obj: RPN.level_topk(obj, level_sizes,
                                                           cfg.pre_nms_top_n_test),
            "plus_gather": plus_gather, "plus_nms": plus_nms,
            "full_filter": lambda props, obj: RPN.filter_proposals(props, obj, level_sizes,
                                                                   image_size, cfg)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--stages", nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = RPN.RPNConfig()
    level_sizes = level_sizes_of(args.size)
    hw = (args.size, args.size)
    props, obj = make_inputs(args.bs, args.size, dev)
    stages = build_stages(level_sizes, hw, cfg)
    if args.stages:
        stages = {k: v for k, v in stages.items() if k in args.stages}
    with torch.inference_mode():
        ms, marginal = prefix_times(stages, props, obj, iters=args.iters, device=dev)
        synchronize(dev)
        before = KN.launches
        full = RPN.filter_proposals(props, obj, level_sizes, hw, cfg)
        launches = KN.launches - before
        boxes, flat = build_stages(level_sizes, hw, cfg)["plus_nms"](props, obj)
        same = same_detections(full, RPN.merge_survivors(boxes, flat,
                                                         cfg.post_nms_top_n_test))
    if not same:
        raise AssertionError("rpnfilter_ablate: the pieces differ from filter_proposals")
    return timer_line("rpnfilter_ablate", dev, bs=args.bs, size=args.size,
                      level_sizes=list(level_sizes), iters=args.iters, stage_ms=ms,
                      marginal_ms=marginal,
                      img_per_s={k: args.bs / v * 1e3 for k, v in ms.items()},
                      nms_launches_per_full_filter=launches, pieces_equal_filter=same,
                      kept=int(full[2].sum()))


if __name__ == "__main__":
    main()
