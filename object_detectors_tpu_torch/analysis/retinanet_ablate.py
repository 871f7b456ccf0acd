"""RetinaNet stage ablation on one GPU (port of the JAX package's
``analysis/retinanet_ablate.py``).

    python -m object_detectors_tpu_torch.analysis.retinanet_ablate [--bs 8]
        [--size 640] [--fused] [--stages ...] [--iters 12] [--device cpu]

Full-width RetinaNet (ResNet-50-FPN P3-P7, 91 classes, bf16, seeded
weights: the pipeline of ``serve.build_retinanet_pipeline`` on normalized
float input) on one seeded float batch. Cumulative prefixes:
``backbone`` (the model's call cut at its backbone+FPN mark,
``yolo_stages.run_through``), ``backbone_nofpn`` (the ResNet alone),
``head`` (the model's whole call: both towers), then inside the
postprocess ``post_select`` (the per-level select,
``retinanet.select_candidates``), ``post_cap`` (+ the global pre-NMS cap,
``cap_candidates``), ``post_decode`` (+ the gathers, decode and clip,
``decode_candidates``), and ``full``, the pipeline's own call (+ the
class-aware NMS on the NMS kernel, ``csrc/nms.cu``). ``full_pieces`` is
the same path assembled from those pieces and must equal ``full``.
``--fused`` sets the backbone's ``fused`` to "auto" (the fused bottleneck
kernel, ``csrc/fused_block.cu``, in the 13 stride-1 blocks; folded in the
warm-up calls). Each stage is timed with back-to-back calls and one
synchronization at the end (``yolo_stages.time_calls``).

Every truncated stage computes the regression tower: the model's forward
returns both towers, and eager PyTorch drops no work (the JAX timer adds a
1e-30 multiple of the regression output to keep XLA from eliminating it).

Prints one JSON line: the card's name and power limit, each stage's ms,
its marginal over the stage before, its images/s, the NMS and fused
kernels' launches over one ``full`` call, and whether ``full_pieces``
equals ``full`` (a difference raises).

Left out, TPU-only: ``head_fused`` and ``full_fused`` (the packed
``fused_towers`` head), ``post_select_batched``, ``full_batched`` and
``full_perlevel`` (the ``batched`` / ``perlevel`` select modes):
``ROADMAP.md`` ground rules, the measured-loser A/B knobs and the packed
heads are not ported.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_detectors_tpu_torch import serve as S
from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.frcnn_ablate import same_detections
from object_detectors_tpu_torch.analysis.yolo_stages import (
    prefix_times, run_through, synchronize, timer_line,
)
from object_detectors_tpu_torch.kernels import fused_block as KF
from object_detectors_tpu_torch.kernels import nms as KN
from object_detectors_tpu_torch.models import retinanet as RN
from object_detectors_tpu_torch.models.resnet import set_fused
from object_detectors_tpu_torch.ops.nms import batched_nms


def build_stages(size: int = 640, fused: bool = False, device="cuda", model=None):
    """(stages {name: fn(NHWC normalized images)}, the pipeline): the
    module docstring's stages over the pipeline of
    ``serve.build_retinanet_pipeline`` (or one around a copy of
    ``model``)."""
    pipe = S.build_retinanet_pipeline(img_size=size, device=device, model=model)
    if fused:
        set_fused(pipe.model, "auto")
    net, cfg, anchors, hw = pipe.model, pipe.cfg, pipe.anchors, (size, size)

    def backbone_nofpn(images):
        x = images.permute(0, 3, 1, 2).to(net.dtype)
        return net.backbone.resnet(x.contiguous(memory_format=torch.channels_last))

    def post(images, upto):
        cls, reg, level_sizes = net(images)
        cand = RN.select_candidates(cls, level_sizes, cfg, 1.0)
        if upto == "select":
            return cand
        scores, labels, aidx, valid = RN.cap_candidates(*cand, cfg)
        if upto == "cap":
            return scores, labels, aidx, valid
        boxes = RN.decode_candidates(reg, anchors, aidx, hw, cfg)
        if upto == "decode":
            return boxes, scores, labels, valid
        out_boxes, out_scores, out_labels, _, out_valid = batched_nms(
            boxes, scores, labels, cfg.nms_thresh, cfg.detections_per_img, valid)
        return out_boxes, out_scores, out_labels, out_valid

    stages = {"backbone": lambda images: run_through(net, "backbone+FPN", images),
              "backbone_nofpn": backbone_nofpn, "head": net,
              "post_select": lambda images: post(images, "select"),
              "post_cap": lambda images: post(images, "cap"),
              "post_decode": lambda images: post(images, "decode"),
              "full": pipe, "full_pieces": lambda images: post(images, "nms")}
    return stages, pipe


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--fused", action="store_true",
                    help="fused bottleneck kernel in the backbone's stride-1 blocks")
    ap.add_argument("--stages", nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    stages, pipe = build_stages(args.size, args.fused, dev)
    if args.stages:
        stages = {k: v for k, v in stages.items() if k in args.stages or k == "full"}
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(args.bs, args.size, args.size, 3).astype(np.float32)
                              ).to(dev, torch.bfloat16)
    with torch.inference_mode():
        ms, marginal = prefix_times(stages, images, iters=args.iters, device=dev)
        synchronize(dev)
        before = {"nms": KN.launches, "fused_block": KF.launches}
        full = pipe(images)
        launches = {"nms": KN.launches - before["nms"],
                    "fused_block": KF.launches - before["fused_block"]}
        same = same_detections(full, stages["full_pieces"](images))
    if not same:
        raise AssertionError("retinanet_ablate: full_pieces differs from the pipeline's call")
    return timer_line("retinanet_ablate", dev, bs=args.bs, size=args.size, dtype="bfloat16",
                      fused=args.fused, iters=args.iters, stage_ms=ms, marginal_ms=marginal,
                      img_per_s={k: args.bs / v * 1e3 for k, v in ms.items()},
                      launches_per_full_call=launches, full_pieces_equal=same,
                      kept=int(full[3].sum()))


if __name__ == "__main__":
    main()
