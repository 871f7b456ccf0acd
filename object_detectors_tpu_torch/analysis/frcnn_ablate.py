"""Faster R-CNN stage ablation on one GPU (port of the JAX package's
``analysis/frcnn_ablate.py``).

    python -m object_detectors_tpu_torch.analysis.frcnn_ablate [--bs 8]
        [--size 640] [--f32] [--stages ...] [--iters 12] [--device cpu]

Full-width Faster R-CNN (ResNet-50-FPN, 91 classes, seeded weights: the
model of ``pipeline.build_frcnn_pipeline_uint8``) on one seeded float batch
in bf16 (``--f32``: float32). Cumulative prefixes of the model's own call,
each cut at one of its stage marks (``yolo_stages.run_through``):
``backbone``, ``rpn_head``, ``proposal_filter``, ``roi_align``,
``box_heads``, ``full`` (the whole call). Inside the proposal filter:
``filter_topk`` (the per-level top-k, gathers, clip and small-box mask,
``rpn.level_candidates``) and ``filter_nms`` (the per-level NMS on the
NMS kernel, ``rpn.level_survivors``). Leave-one-out: ``full_pieces`` is the
detection path assembled from the same pieces (it must equal ``full``),
``full_no_pooler`` and ``full_no_filter`` swap the pooler, or the filter,
for a stand-in of the same output shape at about no cost (the JAX "dummy"
modes), so ``full_pieces`` minus either is that stage's marginal in
context. Each stage is timed with back-to-back calls and one
synchronization at the end (``yolo_stages.time_calls``). The RoIAlign
forward (``csrc/roi_align.cu``) and NMS (``csrc/nms.cu``) kernels run on
this path; their launches over one ``full`` call are counted.

Prints one JSON line: the card's name and power limit, each stage's ms,
its marginal over the stage before, its images/s, the launches, and
whether ``full_pieces`` equals ``full`` (kept sets, labels, scores and
boxes bitwise; a difference raises).

Left out, TPU-only: the per-level top-k A/B ``filter_topk_perlevel`` and
the pooler modes ``full_pooler_dma``, ``full_pooler_compute``,
``full_xalign16``, ``full_nofix``, ``full_prep_only``, ``full_noperm``,
``full_oldprep``, ``full_prep_only_old``, ``full_pair``, ``full_sortlite``,
``full_sortlite_pair`` (``ROADMAP.md`` ground rules: the measured-loser
A/B knobs and the RoIAlign window tiers are not ported); the fixed-point
NMS loop's ``filter_nms_u4`` (``fp_unroll``) and ``filter_nms_c512``
(``fp_chunk``), knobs of a TPU loop the NMS kernel replaces ("Port the
function, not the TPU layout"); ``--pooler`` (the TPU pooler
implementations; the port has the one kernel).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.yolo_stages import (
    prefix_times, run_through, synchronize, timer_line,
)
from object_detectors_tpu_torch.kernels import nms as KN
from object_detectors_tpu_torch.kernels import roi_align as KR
from object_detectors_tpu_torch.models import rpn as RPN
from object_detectors_tpu_torch.models.roi_heads import postprocess_detections
from object_detectors_tpu_torch.ops.boxes import clip_boxes_to_image
from object_detectors_tpu_torch.ops.nms import gather_rows
from object_detectors_tpu_torch.ops.roi_align import pool_multiscale
from object_detectors_tpu_torch.ops.selection import radix_topk
from object_detectors_tpu_torch.pipeline import build_frcnn_pipeline_uint8


def _no_mark(name):
    pass


def dummy_filter(proposals, objectness, image_size, post_n: int):
    """The filter's stand-in: the global top-``post_n`` proposals by
    objectness, clipped, no NMS."""
    topv, topi = radix_topk(objectness, post_n)
    return clip_boxes_to_image(gather_rows(proposals, topi), image_size), topv, \
        torch.isfinite(topv)


def dummy_pool(features, boxes, output_size=(7, 7)):
    """The pooler's stand-in: the top-left ``output_size`` corner of the
    finest map, repeated for every RoI."""
    oh, ow = output_size
    cell = features[0][:, :, :oh, :ow].permute(0, 2, 3, 1)[:, None]   # [B, 1, oh, ow, C]
    scale = (boxes[..., 2] - boxes[..., 0])[..., None, None, None]
    return cell * (1.0 + 0.0 * scale).to(cell.dtype)


def detect_pieces(model, images, filter_mode: str = "real", pooler_mode: str = "real"):
    """The model's detection path assembled from its pieces, the filter or
    the pooler swapped for its stand-in where asked."""
    cfg = model.cfg
    feats, objectness, deltas, level_sizes, size = model._trunk(images, _no_mark)
    proposals = model.decode(feats, deltas, size)
    if filter_mode == "real":
        boxes, _, valid = RPN.filter_proposals(proposals, objectness, level_sizes, size,
                                               cfg.rpn)
    else:
        boxes, _, valid = dummy_filter(proposals, objectness, size,
                                       cfg.rpn.post_nms_top_n_test)
    if pooler_mode == "real":
        pooled = pool_multiscale(feats[:4], boxes, size, cfg.roi.pool_size)
    else:
        pooled = dummy_pool(feats, boxes, cfg.roi.pool_size)
    class_logits, box_regression = model.box_predictor(model.box_head(pooled.to(model.dtype)))
    return postprocess_detections(class_logits.float(), box_regression.float(), boxes, valid,
                                  size, cfg.roi)


def build_stages(dtype=torch.bfloat16, size: int = 640, device="cuda", model=None):
    """(stages {name: fn(NHWC images)}, the model): the module docstring's
    stages over the model of ``build_frcnn_pipeline_uint8`` (or a copy of
    ``model``)."""
    model = build_frcnn_pipeline_uint8(img_size=size, dtype=dtype, device=device,
                                       model=model).model
    cfg = model.cfg

    def through(stage):
        return lambda images: run_through(model, stage, images)

    def through_filter(images, nms: bool):
        feats, objectness, deltas, level_sizes, hw = model._trunk(images, _no_mark)
        boxes, scores = RPN.level_candidates(model.decode(feats, deltas, hw), objectness,
                                             level_sizes, hw, cfg.rpn)
        return RPN.level_survivors(boxes, scores, cfg.rpn) if nms else (boxes, scores)

    stages = {"backbone": through("backbone+FPN"), "rpn_head": through("RPN head"),
              "filter_topk": lambda images: through_filter(images, False),
              "filter_nms": lambda images: through_filter(images, True),
              "proposal_filter": through("proposal filter"), "roi_align": through("pooler"),
              "box_heads": through("box head"), "full": model,
              "full_pieces": lambda images: detect_pieces(model, images),
              "full_no_pooler": lambda images: detect_pieces(model, images,
                                                             pooler_mode="dummy"),
              "full_no_filter": lambda images: detect_pieces(model, images,
                                                             filter_mode="dummy")}
    return stages, model


def same_detections(a, b) -> bool:
    """Two (boxes, scores, labels, valid) bitwise equal."""
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--stages", nargs="*", default=None)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.bfloat16

    stages, model = build_stages(dtype, args.size, dev)
    if args.stages:
        stages = {k: v for k, v in stages.items() if k in args.stages or k == "full"}
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(args.bs, args.size, args.size, 3).astype(np.float32)
                              ).to(dev, dtype)
    with torch.inference_mode():
        ms, marginal = prefix_times(stages, images, iters=args.iters, device=dev)
        synchronize(dev)
        before = {"roi_align": KR.launches, "nms": KN.launches}
        full = stages["full"](images)
        launches = {"roi_align": KR.launches - before["roi_align"],
                    "nms": KN.launches - before["nms"]}
        same = same_detections(full, detect_pieces(model, images))
    if not same:
        raise AssertionError("frcnn_ablate: full_pieces differs from the model's own call")
    return timer_line("frcnn_ablate", dev, bs=args.bs, size=args.size,
                      dtype=str(dtype).replace("torch.", ""), iters=args.iters, stage_ms=ms,
                      marginal_ms=marginal,
                      img_per_s={k: args.bs / v * 1e3 for k, v in ms.items()},
                      launches_per_full_call=launches, full_pieces_equal=same,
                      kept=int(full[3].sum()))


if __name__ == "__main__":
    main()
