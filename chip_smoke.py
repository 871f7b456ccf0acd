#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as JSON lines:

1. device: the card (nvidia-smi name and power limit), torch and CUDA
   versions; exits 1 without a GPU.
2. build: compiles the four CUDA sources (five kernels: roi_align.cu holds
   the RoIAlign forward and backward) from
   ``object_detectors_tpu_torch/csrc`` with nvcc, and the host library of the
   COCO matcher (coco_eval_core.cpp) with g++, one process per source, all at
   once; each one timed.
3. kernel: holds the normalize kernel bitwise equal to its plain PyTorch
   version at 128x640x640x3, at ragged shapes and at a base offset by one byte.
4. e2e: full-width YOLOv3 (Darknet-53, 80 classes, 640², bf16, seeded random
   weights) through ``build_pipeline_uint8`` at batch 128 (the batch of the
   JAX bench's ``yolo640`` row) on three distinct pre-staged uint8 batches:
   2 warm-up calls, 10 timed calls, one final sync. The normalize and NMS
   kernels' launch counts are set to 0 before and read after (one each a
   call). Then a line at batch 64 (the batch of the earlier runs), and the
   kernel alone timed with CUDA events beside its bound and its plain
   version.
5. consistency: two images through the port in f32 on the GPU (TF32 off) and
   on the CPU; raw outputs must agree within the stated tolerance, and
   ``nms_majority`` must give identical results on both devices.
6. serving: the port bench's serving row (``run_serving``: 256 requests,
   YOLO top-512 and RetinaNet at 4:1, flushes of 64 and 16 from a 32-image
   pool on the card, after a warm-up stream of 80): images/s, the
   responses' p50 and p99 latency, the flushes per model and their sizes,
   256 distinct request ids, one normalize and one NMS launch a flush;
   every response bitwise equal to its row of its flush's batch run again
   through its pipeline (same card, same batch shape); one flush of each
   model dispatched under the sync debug mode with no host sync.
7. yolo_lvis416: the port bench's row (1203 classes, 416², batch 16,
   top-300, 300 detections): images/s and the launches of its 11 calls;
   two images in f32 (TF32 off) on the GPU and the CPU: raw maps within
   RAW_RTOL, ``nms_majority`` identical.
8. nms_majority: at yolo640's candidates (128 x 256), a serving YOLO
   flush's (64 x 512), yolo_lvis416's (16 x 300, 1203 classes) and the
   bench's three NMS distributions (512 x 256): identical to the scan
   method and to the port on the CPU, one NMS kernel launch a call, and a
   call under ``torch.cuda.set_sync_debug_mode("error")``; its time beside
   the scan's and the kernel's at the call's inputs beside its bound.
9. nms_latency: the port bench's ``run_nms_latency``: p50 and max-of-means
   in microseconds an image at the three distributions.
10. yolo_neck: full-width YOLOv3-SPP and YOLOv3 with the FPN neck on two
   320² images in f32 (TF32 off), GPU against CPU within RAW_RTOL.
11. kernel (roi_align, nms): the RoIAlign kernel against its plain version at
   the Faster R-CNN shape and at ragged ones (tolerances at ROI_*), with the
   level it computed for each RoI against ``assign_fpn_levels`` (boxes at
   the LevelMapper boundaries too) and each RoI's branch (footprint staged
   in shared memory, or corners read directly) against
   ``staged_rois``, both branches in one launch; the NMS kernel equal to
   its plain version on clustered candidates at both of the path's call
   shapes, with exact score ties and with every box dead, at RetinaNet's
   shape and at 4096 spread boxes with K at 64-box chunk edges.
12. frcnn_e2e: full-width Faster R-CNN R50-FPN (91 classes, 640², bf16,
   seeded random weights) through ``build_frcnn_pipeline_uint8`` at batch 16
   on three distinct pre-staged uint8 batches: 2 warm-up calls, 8 timed
   calls, one final sync; every kernel's launch count is set to 0 before the
   timed calls and read after. Then the stage times (CUDA events) and each
   new kernel alone at the path's own inputs, beside its bound and its plain
   version: for RoIAlign the RoIs of each branch and the bytes gathered from
   L2 before (every sample's corners) and after (each footprint once); for
   NMS the kept counts and the device time of its sort, mask and sweep
   launches from a torch.profiler trace.
13. frcnn_consistency: one image in f32 (TF32 off) on the GPU and on the CPU:
   FPN maps and RPN outputs within the stated tolerance; the RoIAlign kernel
   against the plain version on the CPU for the same proposals; the NMS
   kernel identical to the plain version on the CPU on the RPN's real
   per-level candidates.
14. kernel (fused_block): the fused bottleneck kernel against its plain
   version (TF32 off) at the five ResNet-50 block shapes of a 640² batch of
   16 and at odd shapes of both variants (v4: TMA + wgmma, for channels
   that are multiples of 64; v2: mma.sync, for the tests' tiny blocks), with
   and without the projection, within the JAX test's tolerance and within
   one bf16 ulp of max(|plain|, 1), with a bounded share of elements not
   bitwise equal and none at v2's tiny shapes; each line names the variant,
   its cluster size, tile and grid. At the five shapes, on a block prepared
   once (folded weights in the kernel's layout), its time beside the plain
   version's, the bound, the unfused cuDNN block's, the TFLOP/s and the
   weight bytes the design moves from L2 a launch.
15. retinanet_e2e: full-width RetinaNet R50-FPN (91 classes, 640², bf16,
   seeded random weights) through ``build_retinanet_pipeline_uint8`` at
   batch 16, timed as frcnn_e2e, with the backbone unfused and then fused
   (``backbone_fused="auto"``: 13 kernel launches a call); every kernel's
   launch count is set to 0 before each timed run and read after.
16. frcnn_fused: frcnn640's backbone+FPN alone with the backbone unfused and
   fused, and the batch-norm fold: cold (caches emptied: fold, kernel
   layout, TMA descriptors of the 13 blocks, device time) and warm (a
   forward that finds every block's cache: folds counted, device work traced,
   and the host time of the cache check).
17. retinanet_post: the postprocess on seeded live bf16 logits [16, 76725,
   91] around the score threshold, on the GPU and on the CPU: labels, valid
   and order identical, boxes and scores within the stated tolerance; the
   NMS kernel timed at its shape there (16 x 2000, K 300), with its phases.
18. retinanet_consistency: one image in f32 (TF32 off) on the GPU and on
   the CPU: the head's outputs within the stated tolerance.
19. kernel (roi_align_backward): the RoIAlign backward kernel against its
   plain version (autograd of the plain pooler) at the Faster R-CNN
   training shape, a cotangent [2, 512, 7, 7, 256] on P2-P5 of an 800²
   image, at an odd one and at a 14x14 one, in f32 (within ROI_F32_*: the
   reductions add in a changing order) and bf16 (within one bf16 ulp of
   max(|plain|, 1)), each RoI's route (level; staged or direct) against
   ``backward_routes``; at the training shape its time (the wrapper, the
   zeroing alone, and the device time of the zeroing, the kernel and the
   rounding from a trace, or where CUPTI gives back only empty traces the
   wrapper's time less the zeroing's) beside the plain version's and the bound from
   the bytes it must move and the operations its samples need; its
   kernel_time line adds the reductions it issues beside a scatter's
   corner updates, both counted on the host, which the kernels line
   leaves out.
20. yolo_train: the port bench's yolo_train416 row (batch 128, 416², bf16
   activations): images/s, ms a step, mfu, peak memory, a finite loss;
   the tiny Darknet step of ``train/tiny_steps.py`` at 96 px (TF32 off) on
   the GPU against the CPU: losses within its TRAIN_LOSS_RTOL, the update
   as a whole in f32 and each tensor's in f64 within its stated shares.
   Prints whether TF32 is on.
21. frcnn_train: Faster R-CNN R50-FPN training at 800², batch 2 (RPN
   2000/2000, 512 RoIs a image, f32, SGD 0.0025 with momentum, weight decay
   and warmup): ms a step, images/s, finite losses, and per step exactly one
   launch of the RoIAlign forward, of its backward and of NMS; one more
   step with the three wrappers watched, each kernel then held against its
   plain version at the inputs that step gave it (the RPN filter's 2 x 5
   groups at K 2000 identical, the f32 RoIAlign forward and backward at
   512 RoIs an image within ROI_F32_*), NMS timed there and the backward
   (f32 and bf16) at the step's own cotangent and RoIs; the tiny Faster
   R-CNN step of ``train/tiny_steps.py`` at 64 px on the GPU against the
   CPU with the same draws.

22. protocol: the port bench's ``run_protocol`` in its seeded branch at full
   width (Darknet-53, 80 classes, 416², bf16; 256 images; batch sizes 2 to
   128), one run a batch size (the CLI's two would not fit the time limit):
   each row's forw_time, cpu_time, app_time, mAP, detections and the share
   of app_time outside the pipeline calls (host batches, copies,
   evaluation), the rows also in chiprun_out/protocol_rows.csv; one NMS
   launch a pipeline call. Then 8 of its images in f32 (TF32 off) on the GPU
   and the CPU: raw maps within RAW_RTOL, ``nms_majority`` identical on the
   GPU's candidates, the evaluator's results on the card's NMS output
   identical to those on the CPU's, stats within 1e-6; the two whole
   pipelines: the same (image, category) results with their boxes within
   RAW_ATOL carried through the decode and stats within 1e-6 (their order is
   not compared: near-tied scores swap neighbours). Then protocol_trained:
   the bench's ``--protocol`` CLI (batch sizes 8 and 64) with a seeded tiny
   YOLO saved in ``make_artifacts``' format into a temporary artifacts
   directory: the trained branch must run (``"weights": "trained"``, the
   meta's 64² size, at most 20 detections an image).
23. eval_planted: the JAX round-trip test on the card: a renderable set of
   32 images of 480² to 640² through ``yolo_batches_uint8`` (640² canvas),
   the canvas resized to 416 on the GPU against the CPU (f32 within 1e-5,
   bf16 within one bf16 ulp of max(|cpu|, 1)); each GT planted as a candidate
   with three jittered duplicates; ``nms_majority`` on the card (one NMS
   launch a batch) identical to the CPU; the evaluator's stats equal; mAP
   and the GT pairs above IoU 0.6.
24. ingest: the two canvas resizes timed (CUDA events) at [16, 640, 640, 3]
   -> 416 (bicubic) and [2, 640, 640, 3] -> 800² (bilinear), with their
   bytes and bounds; each family's tiny ingest train step on the GPU against
   the CPU (the Faster R-CNN one launching RoIAlign forward, backward and NMS
   once).

25-31. detection_main's architectures through ``ModelAdapter`` at its CLI's
   defaults (800², batch 2, f32 with TF32 for cuDNN, seeded weights, the
   91-way class scores scaled by CLS_SCALE; frcnn_train800's GT: 20 slots,
   70 % valid, masks the boxes' interiors, 17 keypoints in each box):
   maskrcnn800 and kprcnn800 (``detect_with_masks``,
   ``detect_with_keypoints``: ms a batch, two RoIAlign launches a call, the
   7x7 box pooler and the 14x14 branch pooler, and two NMS; the 14x14
   pooler against its plain version at its own maps and detections, timed
   beside its bound with its staged and direct RoIs; Keypoint R-CNN's exact
   decode timed at its own logits; one image GPU vs CPU: FPN maps and RPN
   outputs within FEAT_*, then the rest of the path on both devices from
   the GPU's maps, kept sets identical), maskrcnn_train800 and
   kprcnn_train800 (``detection_train_step``: ms a step, peak memory, two
   RoIAlign forwards, two backwards and one NMS a step; the 14x14 backward
   at a step's own cotangent [2, 512, 14, 14, 256] against its plain
   version, timed beside its bound; the tiny GPU-vs-CPU step of
   ``tiny_steps.adapter_step_on_both``), ssd300 (``detect`` at 300²: one
   NMS launch a call, the kernel identical to its plain version at the
   postprocess's own 2 x 1200 candidates and timed there; raw outputs GPU vs
   CPU, the postprocess on both devices from the GPU's outputs identical),
   ssd_train300 and retinanet_train800 (ms a step, peak memory, the tiny
   step).

32. yolo_cli416: the port's YOLO CLI in-process, ``main.main(["train",
   "dataset=synthetic", "backbone=darknet53", "dataset.inp_dim=416", ...])``:
   the full Darknet-53 at 416², bf16, 32 synthetic images, batch 8, one
   epoch with mAP selection; then ``evaluate --checkpoint best --dump-json``
   and ``resume=true epochs=2``, output under chiprun_out/yolo_cli416 (the
   checkpoints' weight files deleted at the end).
   Finite losses, last and best with their sidecars, the resume starting at
   epoch 1 from parameters and optimizer state bitwise those saved, one NMS
   launch an eval batch, one eval batch's kept sets identical to the plain
   ``nms_majority`` on the CPU at that batch's candidates, a finite mAP, ms
   a train step and an eval batch.
33. frcnn_cli800: the port's ``detection_main.main`` in-process: the full
   R50-FPN Faster R-CNN at 800², batch 2, 8 boxes, one epoch on the
   synthetic set; ``--test-only --resume last --dump-json``; one
   ``--device-ingest`` epoch; output under chiprun_out/frcnn_cli800 (weight
   files deleted at the end). One
   RoIAlign forward, backward and NMS launch a training step (both epochs),
   the launches of an eval batch, each kernel held against its plain
   version at one CLI step's own inputs (``check_frcnn_train_kernels``), a
   finite mAP, ms a step and an eval batch.
34. ddp: data-parallel training over two processes on the one card, over
   gloo (NCCL takes one rank a device), each process started by this
   script (``--ddp-rank``) and running both CLIs' ``main(argv)`` as a user's
   ``torchrun`` would: yolo_cli416's configuration (Darknet-53, 416², 32
   images, 8 a global step) and frcnn_cli800's (R50-FPN, 800², 2 images a
   rank), one epoch each in f32 with TF32 off, output under
   chiprun_out/ddp. Each rank's launches counted from 0 before each run:
   one RoIAlign forward, backward and NMS a Faster R-CNN step, one NMS a
   YOLO eval batch; only rank 0 writes checkpoints; the ranks' parameters
   equal at the end; the first step's losses (the mean of the ranks'
   shares) within DDP_LOSS_RTOL and its gradients (averaged by DDP) against
   one process's step on the same global batch from the same seeded
   weights and sampler draws, the YOLO's as a whole within
   YOLO_F32_UPDATE_NORM, Faster R-CNN's per tensor within
   FRCNN_UPDATE_SHARE; ms a step and an eval batch of each rank beside the
   card's name and power limit.
35. analysis: the ten timers of ``object_detectors_tpu_torch/analysis/``
   (``ANALYSIS_TIMERS``: darknet_ablate, backbone_ablate --fused
   --stem-detail, frcnn_ablate, retinanet_ablate --fused, rpnfilter_ablate,
   roialign_bench, topk_bench, decode_bench, train_ablate, serving_ablate)
   through their ``main`` at their default full-width shapes with
   ``--iters 2``, the kernels' launch counts set to 0 before each and read
   after: one JSON line each with the card, every time finite and
   positive, and each timer's own checks (pieces equal to the pipeline's
   call, RoIAlign kernel within its gates of the plain version, decode
   formulations bitwise equal, top-k sets equal, the training model
   untouched) with the launches of its path: frcnn_ablate 1 RoIAlign and
   2 NMS a full call, retinanet_ablate 1 NMS and 13 fused a call, one NMS
   a proposal filter, one normalize and one NMS a serving flush.

Phase 27-31's 14x14 RoIAlign backward lines carry its plain version's
time at the branch's own cotangent.

The line before the last is the kernel table as JSON (only numbers this run
measured, and the bounds); the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

BATCH, IMG, NUM_CLASSES = 128, 640, 80
LVIS_BATCH, LVIS_IMG, LVIS_CLASSES = 16, 416, 1203
FRCNN_BATCH, FRCNN_CLASSES = 16, 91
RETINA_BATCH, RETINA_CLASSES = 16, 91
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores, published
RAW_RTOL = RAW_ATOL = 1e-3      # f32 GPU vs CPU raw maps (see phase 5)
# RoIAlign kernel vs plain: in f32 the same sample positions and weights
# (no FMA contraction on either side) summed in another order; in bf16 one
# rounding of that f32 result, so one bf16 ulp (2^-7 relative) on top.
ROI_F32_RTOL, ROI_F32_ATOL = 1e-4, 1e-5
ROI_BF16_RTOL, ROI_BF16_ATOL = 2 ** -7, 1e-5
FEAT_RTOL = FEAT_ATOL = 1e-3    # f32 GPU vs CPU FPN maps and RPN outputs (phase 13)
IOU_OPS = 13                    # f32 operations of one IoU and its compare
# fused bottleneck kernel vs plain, and its bf16 output against the plain
# chain: the tolerance of tests/test_fused_block.py (bf16 + BN-fold rounding)
FUSED_RTOL, FUSED_ATOL, FUSED_MEAN = 0.1, 0.15, 1e-2
# ... and, since the kernel and its plain version take the same folded
# operands and round at the same points, what is left is f32 summation order
# and the bf16 roundings it flips: the largest difference within one bf16 ulp
# of max(|plain|, 1) over the whole output (a flip of t2 can carry an element
# below 2 by two of its own ulps), at most this share of elements not
# bitwise equal (3.4 % seen at layer4, where the sums are longest), and the
# short sums of the tiny shapes bitwise equal
FUSED_MAX_ULPS, FUSED_UNEQUAL_SHARE = 1.0, 0.1
BF16_TC_OPS_PER_S = 989.4e12    # H100 SXM dense bf16 tensor cores, published
# the stride-1 blocks of ResNet-50 on a 640² image: (count, H, Cin, Cm, Cout,
# projection); 13 launches a forward
RESNET50_FUSED_BLOCKS = ((1, 160, 64, 64, 256, True), (2, 160, 256, 64, 256, False),
                         (3, 80, 512, 128, 512, False), (5, 40, 1024, 256, 1024, False),
                         (2, 20, 2048, 512, 2048, False))
FROZEN_RANGES = {"weight": (0.5, 1.5), "bias": (-0.1, 0.1), "running_mean": (-0.1, 0.1),
                 "running_var": (0.5, 1.5)}
# RetinaNet postprocess, GPU vs CPU port: scores within 1e-5; the decode's
# exp can differ by an ulp between the devices, and a corner is a difference
# of values up to 640 px, so boxes agree to two f32 ulps at 640 (2^-13)
SCORE_ATOL, BOX_ATOL = 1e-5, 2.0 ** -13
# the bench's --protocol (416², 256 images) and eval_planted's canvas and sizes
PROTOCOL_IMG, PROTOCOL_IMAGES, CANVAS = 416, 256, 640
PLANTED_SIZES = ((480, 480), (480, 640), (600, 480), (640, 640))


def emit(**fields):
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, iters: int, tries: int = 3) -> list:
    """The device events of a torch.profiler trace of ``iters`` calls of
    fn. CUPTI now and then hands back a trace that holds no device event
    at all, though the launches ran (their counts and results show it): such
    a trace is taken again, up to ``tries`` times in all; [] if every one
    came back empty."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return []


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def phase_kernel(P):
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [((BATCH, IMG, IMG, 3), 0), ((3, 97, 131, 3), 0), ((3, 97, 131, 3), 1),
             ((BATCH, IMG, IMG, 3), 1), ((1, 1, 5, 3), 0)]
    worst = 0.0
    for shape, offset in cases:
        n = int(np.prod(shape))
        buf = torch.randint(0, 256, (n + offset,), dtype=torch.uint8, device="cuda",
                            generator=g)
        u8 = buf[offset:].view(shape)
        for dtype in (torch.bfloat16, torch.float32):
            out = P.preprocess_images_cuda(u8, dtype)
            ref = P.preprocess_images_reference(u8, dtype)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            worst = max(worst, err)
            equal = torch.equal(bits(out), bits(ref))
            emit(phase="kernel", name="preprocess", shape=list(shape), base_offset=offset,
                 out_dtype=str(dtype), bitwise_equal=equal, max_abs_err=err)
            check(equal, f"preprocess kernel differs from its plain version at {shape}")
            check(out.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last),
                  "preprocess output is not channels_last")
    return worst


def phase_e2e(P, KN, PL):
    pipe = PL.build_pipeline_uint8(num_classes=NUM_CLASSES, img_size=IMG, device="cuda")
    rng = np.random.RandomState(0)
    host = [rng.randint(0, 255, (BATCH, IMG, IMG, 3), dtype=np.uint8) for _ in range(3)]
    batches = [torch.from_numpy(b).cuda() for b in host]
    torch.cuda.synchronize()

    for i in range(2):
        out = pipe(batches[i % 3])
    float(out[1].sum())  # host read
    P.launches = KN.launches = 0
    t0 = time.perf_counter()
    outs = [pipe(batches[i % 3]) for i in range(10)]
    float(outs[-1][1].sum())  # one final sync
    dt = (time.perf_counter() - t0) / 10
    launches, nms_launches = P.launches, KN.launches

    boxes, scores, labels, valid = outs[-1]
    check(tuple(boxes.shape) == (BATCH, 100, 4) and tuple(valid.shape) == (BATCH, 100),
          "e2e output shape")
    check(bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()),
          "e2e output is not finite")
    check(launches == 10, f"the e2e run launched the preprocess kernel {launches} times in "
                          f"10 calls")
    check(nms_launches == 10, f"the e2e run launched the NMS kernel {nms_launches} times in "
                              f"10 calls")
    emit(phase="e2e", batch=BATCH, img=IMG, imgs_per_s=BATCH / dt, ms_per_batch=dt * 1e3,
         valid_detections=int(valid.sum()), preprocess_launches=launches,
         nms_launches=nms_launches, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    candidates = pipe.candidates(batches[0])
    half = [b[:64] for b in batches]
    for i in range(2):
        out = pipe(half[i % 3])
    float(out[1].sum())  # host read
    t0 = time.perf_counter()
    outs = [pipe(half[i % 3]) for i in range(10)]
    float(outs[-1][1].sum())
    dt = (time.perf_counter() - t0) / 10
    emit(phase="e2e", batch=64, img=IMG, imgs_per_s=64 / dt, ms_per_batch=dt * 1e3,
         note="batch 64, the batch of the runs before batch 128")

    u8 = batches[0]
    ms = cuda_ms(lambda: P.preprocess_images_cuda(u8), 20)
    plain_ms = cuda_ms(lambda: P.preprocess_images_reference(u8), 20)
    n = u8.numel()
    moved = n * 1 + n * 2  # uint8 in, bf16 out; 3 f32 ops per byte never bind
    bound = moved / HBM_BYTES_PER_S * 1e3
    emit(phase="kernel_time", name="preprocess", shape=list(u8.shape), ms=ms,
         plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", bytes=moved,
         achieved_tb_per_s=moved / (ms * 1e-3) / 1e12)
    return batches, candidates, nms_launches, dict(launches=launches, ms=ms, plain_ms=plain_ms,
                                                   bound_ms=bound, bound_by="bytes")


def clustered_candidates(seed: int, batch: int, n: int):
    """Seeded candidates in tight clusters with scores above conf 0.1."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(batch, 8, 2) * IMG
    which = rng.randint(0, 8, (batch, n))
    cxy = np.take_along_axis(centers, which[..., None], 1) + rng.randn(batch, n, 2) * 6
    wh = 40 + rng.rand(batch, n, 2) * 20
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = (0.1 + 0.9 * rng.randint(1, 50, (batch, n)) / 50).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, (batch, n)).astype(np.int32)
    return [torch.from_numpy(a) for a in (boxes, scores, labels)]


def same_nms(N, phase, name, b, s, c, v, num_classes=NUM_CLASSES, max_output=100,
             method="fixedpoint"):
    """nms_majority (IoU 0.6) on the GPU and on the CPU: identical, or
    raise. Returns (the GPU's output, the kept count)."""
    on_gpu = N.nms_majority(b.cuda(), s.cuda(), c.cuda(), num_classes, 0.6, max_output,
                            valid=None if v is None else v.cuda(), method=method)
    on_cpu = N.nms_majority(b.cpu(), s.cpu(), c.cpu(), num_classes, 0.6, max_output,
                            valid=None if v is None else v.cpu(), method=method)
    identical = all(torch.equal(x.cpu(), y) for x, y in zip(on_gpu, on_cpu))
    kept = int(on_cpu[3].sum())
    emit(phase=phase, what=f"nms_majority {name} ({method})", identical=identical,
         candidates=list(s.shape), num_classes=num_classes, kept=kept)
    check(identical, f"nms_majority differs between GPU and CPU on {name}")
    return on_gpu, kept


def phase_consistency(PL, N, u8):
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kw = dict(num_classes=NUM_CLASSES, img_size=IMG, dtype=torch.float32)
        gpu = PL.build_pipeline_uint8(device="cuda", **kw)
        cpu = PL.build_pipeline_uint8(device="cpu", **kw)
        raw_gpu = [o.cpu() for o in gpu.raw_outputs(u8)]
        raw_cpu = cpu.raw_outputs(u8.cpu())
        # f32 on both, but cuDNN and the CPU sum the 75 convolutions in other
        # orders: allow 1e-3 relative, far above f32 rounding, far below a bug
        for g, c in zip(raw_gpu, raw_cpu):
            err = (g - c).abs().max().item()
            emit(phase="consistency", what="raw", shape=list(g.shape), max_abs_err=err,
                 max_abs_ref=c.abs().max().item())
            torch.testing.assert_close(g, c, rtol=RAW_RTOL, atol=RAW_ATOL)
        boxes, scores, labels, valid = gpu.candidates(u8)
    finally:
        torch.backends.cudnn.allow_tf32 = allow

    same_nms(N, "consistency", "pipeline top-k, conf mask", boxes, scores, labels, valid)
    same_nms(N, "consistency", "pipeline top-k, all valid", boxes, scores, labels, None)
    cb, cs, cl = clustered_candidates(1, 4, 256)
    fixed, kept = same_nms(N, "consistency", "clustered", cb, cs, cl, cs > 0.1)
    check(0 < kept < cs.numel(), "clustered case kept nothing or suppressed nothing")
    scan, _ = same_nms(N, "consistency", "clustered", cb, cs, cl, cs > 0.1, method="scan")
    check(all(torch.equal(a, b) for a, b in zip(fixed, scan)),
          "fixed point and scan disagree on the GPU")


def time_bound(moved: float, ops: float):
    """The least time for the work, in ms, and which of bytes or operations
    sets it."""
    t = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "operations": ops / F32_OPS_PER_S * 1e3}
    by = max(t, key=t.get)
    return t[by], by


def level_maps(seed: int, batch: int, channels: int, dtype, size: int = IMG):
    """Seeded P2-P5 maps [B, C, H, W] in channels_last memory."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(batch, size // s, size // s, channels, generator=g, device="cuda")
            .permute(0, 3, 1, 2).to(dtype) for s in (4, 8, 16, 32)]


def random_rois(seed: int, batch: int, n: int, size: int = IMG) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    xy = rng.rand(batch, n, 2) * (size - 30)
    wh = rng.rand(batch, n, 2) * ((rng.rand(batch, n, 1) > 0.5) * size / 2 + 8)
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).cuda()


def check_roi_align(KR, case, maps, boxes, size=IMG, out_size=(7, 7)):
    """Kernel vs plain version (and, in bf16, vs the f32 kernel) on one input;
    the level the kernel computed for each RoI against ``assign_fpn_levels``
    and its branch (footprint staged in shared memory, or corners read
    directly) against the rule ``staged_rois`` states. Returns (max abs
    error, staged RoIs [B, N] bool)."""
    from object_detectors_tpu_torch.ops.roi_align import assign_fpn_levels

    route = torch.empty(boxes.shape[:2], dtype=torch.uint8, device="cuda")
    got = KR.multiscale_roi_align_cuda(maps, boxes, (size, size), out_size, route=route)
    ref = KR.multiscale_roi_align_reference(maps, boxes, (size, size), out_size)
    rule, foot = KR.staged_rois(maps, boxes, (size, size), out_size)
    levels = torch.equal((route // 2).int(), assign_fpn_levels(boxes, len(maps)))
    staged = (route % 2).bool()
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    f32 = maps[0].dtype == torch.float32
    ulp_ok = True
    if not f32:  # one rounding of the f32 kernel's result
        ref32 = KR.multiscale_roi_align_cuda([m.float() for m in maps], boxes, (size, size),
                                             out_size)
        ulp = (ref32.abs().clamp(min=1e-30).log2().floor() - 7).exp2()
        ulp_ok = bool(((got.float() - ref32).abs() <= ulp).all())
    emit(phase="kernel", name="roi_align", case=case, dtype=str(maps[0].dtype),
         out_shape=list(got.shape), max_abs_err=err, max_abs_ref=ref.float().abs().max().item(),
         within_one_ulp_of_f32_kernel=ulp_ok, staged_rois=int(staged.sum()),
         direct_rois=int((~staged).sum()), footprint_max=int(foot.max()),
         footprints_at_the_stage=int((foot == KR.STAGE_PIXELS).sum()),
         levels_as_assign_fpn_levels=levels, branch_as_the_rule_says=torch.equal(staged, rule))
    rtol, atol = (ROI_F32_RTOL, ROI_F32_ATOL) if f32 else (ROI_BF16_RTOL, ROI_BF16_ATOL)
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=atol)
    check(ulp_ok, f"bf16 RoIAlign kernel is not within one ulp of the f32 kernel ({case})")
    check(levels, f"RoIAlign kernel took other levels than assign_fpn_levels ({case})")
    check(torch.equal(staged, rule), f"RoIAlign kernel staged other RoIs than the rule says "
                                     f"({case})")
    return err, staged


def inside_samples(hws, boxes, size, out_size=(7, 7), s=2) -> torch.Tensor:
    """The samples of each RoI of ``boxes`` [B, N, 4] that lie inside its
    level map (the level maps' sizes ``hws``, of a ``size``² image): [B * N]."""
    from object_detectors_tpu_torch.ops import roi_align as R

    flat = boxes.reshape(-1, 4)
    lv = R.assign_fpn_levels(flat, len(hws)).long()

    def per_roi(values):
        return torch.tensor(values, dtype=torch.float32, device=boxes.device)[lv]

    (oy, *_), (ox, *_) = R.roi_samples(flat, per_roi([R._infer_scale(hw, (size, size))
                                                      for hw in hws]),
                                       per_roi([h for h, _ in hws]), per_roi([w for _, w in hws]),
                                       out_size, s)
    return (~oy).flatten(1).sum(1) * (~ox).flatten(1).sum(1)


def roi_gather_bytes(KR, maps, boxes, staged, size=IMG, out_size=(7, 7), s=2):
    """The bytes a RoIAlign launch gathers from L2 into the SMs: (before,
    after). Before, a kernel that reads every sample's corners from global
    memory: the four corners of every sample inside the map, all channels,
    each sample again. After: the footprint of every RoI the kernel staged
    (``staged``, its own report), once, and the corners of the others as
    before."""
    samples = inside_samples([m.shape[-2:] for m in maps], boxes, size, out_size, s)
    foot = KR.staged_rois(maps, boxes, (size, size), out_size, s)[1].flatten()
    pixel = maps[0].shape[1] * maps[0].element_size()
    st = staged.flatten().bool()
    return (int(samples.sum()) * 4 * pixel,
            int(foot[st].sum()) * pixel + int(samples[~st].sum()) * 4 * pixel)


def phase_roi_align_kernel(KR) -> float:
    worst = 0.0
    boxes = random_rois(0, FRCNN_BATCH, 1000)
    ragged = random_rois(1, 2, 40)
    ragged[0, :6] = torch.tensor([[-50, -40, 30, 20], [0, 0, IMG, 6], [3, 0, 9, IMG],
                                  [20, 20, 20, 20], [40, 40, 30, 30],
                                  [IMG - 2, IMG - 2, IMG + 90, IMG + 60]], device="cuda")
    # on P2 alone, at 7x7: 8 x 17 footprint pixels (two slice buffers
    # exactly), 16 x 17 (the stage exactly, one buffer), 28 x 28 (over it);
    # sides at the LevelMapper boundaries on all four levels
    both = ragged.clone()
    both[0, :4] = torch.tensor([[10, 10, 76, 34], [10, 10, 76, 72], [10, 10, 130, 130],
                                [10, 10, 90, 166]], device="cuda")
    bounds = torch.tensor([[[0, 0, 112, 112], [0, 0, 224, 224], [0, 0, 448, 448],
                            [0, 0, 111.99, 112], [7, 3, 231, 227], [1, 1, 447.99, 448.01]]],
                          device="cuda").repeat(2, 1, 1)
    for dtype in (torch.bfloat16, torch.float32):
        maps = level_maps(0, FRCNN_BATCH, 256, dtype)
        cases = [("Faster R-CNN shape", maps, boxes, IMG, (7, 7))]
        maps = [m[:2] for m in maps]
        cases += [("outside, extreme aspects, degenerate", maps, ragged, IMG, (7, 7)),
                  ("14x14", maps, ragged[:, :12].contiguous(), IMG, (14, 14)),
                  ("N=1", maps, ragged[:, :1].contiguous(), IMG, (7, 7)),
                  ("C=3 (one channel a thread)", level_maps(2, 2, 3, dtype, 128),
                   random_rois(2, 2, 9, 128), 128, (7, 7)),
                  ("LevelMapper boundaries", maps, bounds, IMG, (7, 7)),
                  ("P2 alone: staged and direct RoIs, one at the stage", maps[:1], both, IMG,
                   (7, 7)),
                  ("P2 alone, 14x14: staged and direct RoIs", maps[:1], both, IMG, (14, 14))]
        for case, m, b, size, out in cases:
            err, staged = check_roi_align(KR, case, m, b, size, out)
            worst = max(worst, err)
            if "staged and direct" in case:
                check(bool(staged.any()) and not bool(staged.all()),
                      f"RoIAlign {case}: {int(staged.sum())} of {staged.numel()} staged")
    return worst


def check_nms(KN, case, boxes, scores, thr, k, valid=None) -> int:
    keep, ok = KN.greedy_nms_cuda(boxes, scores, thr, k, valid)
    ref_keep, ref_ok = KN.greedy_nms_reference(boxes, scores, thr, k, valid)
    identical = torch.equal(keep, ref_keep) and torch.equal(ok, ref_ok)
    kept = int(ok.sum())
    emit(phase="kernel", name="nms", case=case, groups=scores.shape[0], n=scores.shape[1],
         k=k, iou_threshold=thr, identical=identical, kept=kept)
    check(identical, f"NMS kernel differs from its plain version ({case})")
    return kept


def phase_nms_kernel(KN):
    for case, seed, groups, k, thr in (("RPN shape", 3, FRCNN_BATCH * 5, 1000, 0.7),
                                       ("postprocess shape", 4, FRCNN_BATCH, 100, 0.5)):
        boxes, scores, _ = [t.cuda() for t in clustered_candidates(seed, groups, 1000)]
        valid = scores > 0.3
        kept = check_nms(KN, case + ", clustered, masked", boxes, scores, thr, k, valid)
        check(0 < kept < int(valid.sum()), f"{case}: NMS kept nothing or dropped nothing")
        check_nms(KN, case + ", all scores tied", boxes, torch.full_like(scores, 0.5), thr, k)
        dead = check_nms(KN, case + ", all dead", boxes, torch.full_like(scores, float("-inf")),
                         thr, k)
        dead += check_nms(KN, case + ", all invalid", boxes, scores, thr, k,
                          torch.zeros_like(valid))
        check(dead == 0, f"{case}: NMS kept a dead box")
    # RetinaNet's shape, boxes offset by class as batched_nms offsets them
    boxes, scores, labels = [t.cuda() for t in clustered_candidates(6, FRCNN_BATCH, 2000)]
    offset = labels.float()[..., None] * (boxes.amax(dim=(1, 2))[:, None, None] + 1.0)
    check_nms(KN, "RetinaNet shape, class offsets", (boxes + offset).contiguous(), scores, 0.5, 300)
    # the most boxes a group takes, spread so that most are kept and the
    # sweep runs through all 64 mask words; K ends at chunk edges and beyond
    rng = np.random.RandomState(7)
    xy = rng.rand(3, 4096, 2) * IMG
    boxes = torch.from_numpy(np.concatenate([xy, xy + 10 + rng.rand(3, 4096, 2) * 60], -1)
                             .astype(np.float32)).cuda()
    scores = torch.from_numpy(rng.rand(3, 4096).astype(np.float32)).cuda()
    for k in (64, 65, 4096):
        check_nms(KN, "4096 spread boxes", boxes, scores, 0.5, k)


def greedy_iou_count(boxes, scores, keep, ok, thr) -> int:
    """The IoUs the greedy kept set needs at least: each kept box against
    the kept boxes before it, each suppressed box against the kept boxes up
    to its first suppressor."""
    from object_detectors_tpu_torch.ops.boxes import pairwise_iou
    from object_detectors_tpu_torch.ops.nms import gather_rows

    kept_boxes = gather_rows(boxes, keep.clamp(min=0).long())
    over = (pairwise_iou(kept_boxes, boxes) > thr) & ok[..., None]  # [G, K, N]
    n = scores.shape[1]
    kept = torch.zeros((scores.shape[0], n + 1), dtype=torch.bool, device=scores.device)
    kept = kept.scatter_(1, torch.where(ok, keep, n).long(), True)[:, :n]  # pads: column n
    suppressed = (scores > float("-inf")) & ~kept & over.any(1)
    first = over.to(torch.int32).argmax(1)
    n_kept = ok.sum(1)
    return int(((first + 1) * suppressed).sum()) + int((n_kept * (n_kept - 1) // 2).sum())


@contextlib.contextmanager
def watched(module, name):
    """While inside, every call of the kernel wrapper ``module.name`` is
    recorded: yields the list of their (args, kwargs), tensors copied as
    they came in."""
    calls = []

    def copy(a):
        if isinstance(a, torch.Tensor):
            return a.detach().clone()
        return type(a)(copy(x) for x in a) if isinstance(a, (list, tuple)) else a

    def spy(*args, **kwargs):
        calls.append((copy(args), kwargs))
        return wrapper(*args, **kwargs)

    wrapper = getattr(module, name)
    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, wrapper)


def nms_kernel_time(KN, b, s, thr, k, valid=None, plain_iters=2):
    """The NMS kernel at one call's inputs: its time and its plain version's
    (CUDA events), its bound (each input read and each output written once,
    against the IoUs its kept set needs at least) and the kept count."""
    keep, ok = KN.greedy_nms_cuda(b, s, thr, k, valid)
    ms = cuda_ms(lambda: KN.greedy_nms_cuda(b, s, thr, k, valid), 20)
    plain_ms = cuda_ms(lambda: KN.greedy_nms_reference(b, s, thr, k, valid), plain_iters)
    moved = ((b.numel() + s.numel() + keep.numel()) * 4 + ok.numel()
             + (0 if valid is None else valid.numel()))
    live = s if valid is None else torch.where(valid, s, float("-inf"))
    ious = greedy_iou_count(b, live, keep, ok, thr)
    bound, bound_by = time_bound(moved, ious * IOU_OPS)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                kept=int(ok.sum()), bytes=moved, ious=ious, operations=ious * IOU_OPS)


MEASURED_NMS = ("ms", "plain_ms", "bound_ms", "bound_by", "phases_ms")


def nms_phase_ms(KN, boxes, scores, thr, k, iters=10):
    """The device time of each of the NMS kernel's three launches (sort,
    IoU mask, sweep) a call, from a torch.profiler trace; "not measured"
    where every trace came back empty (``device_events``)."""
    names = {"nms_sort_kernel": "sort", "nms_mask_kernel": "mask", "nms_sweep_kernel": "sweep"}
    KN.greedy_nms_cuda(boxes, scores, thr, k)
    events = device_events(lambda: KN.greedy_nms_cuda(boxes, scores, thr, k), iters)
    if not events:
        emit(phase="trace", what="NMS phases", note="every trace came back empty")
        return dict.fromkeys(names.values(), "not measured")
    ms = dict.fromkeys(names.values(), 0.0)
    for e in events:
        phase = next((v for key, v in names.items() if key in e.name), None)
        if phase:
            ms[phase] += e.device_time / 1e3 / iters
    check(all(t > 0 for t in ms.values()), f"the NMS trace misses a phase: {ms}")
    return ms


def timed_calls(pipe, batches, counters, iters=8):
    """2 warm-up calls, then ``iters`` back-to-back calls ending in one host
    read; every counter (a kernel module's ``launches``) is set to 0 just
    before the timed calls and read just after. Returns (seconds a call,
    last output, launches by name)."""
    for i in range(2):
        out = pipe(batches[i % 3])
    float(out[1].sum())  # host read
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    outs = [pipe(batches[i % 3]) for i in range(iters)]
    float(outs[-1][1].sum())  # one final sync
    dt = (time.perf_counter() - t0) / iters
    return dt, outs[-1], {name: mod.launches for name, mod in counters.items()}


def phase_frcnn_e2e(PL, P, KR, KN, RPN):
    pipe = PL.build_frcnn_pipeline_uint8(num_classes=FRCNN_CLASSES, img_size=IMG,
                                         device="cuda")
    rng = np.random.RandomState(2)
    batches = [torch.from_numpy(rng.randint(0, 255, (FRCNN_BATCH, IMG, IMG, 3),
                                            dtype=np.uint8)).cuda() for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 8
    dt, (boxes, scores, labels, valid), launches = timed_calls(
        pipe, batches, {"preprocess": P, "roi_align": KR, "nms": KN}, iters)
    check(tuple(boxes.shape) == (FRCNN_BATCH, 100, 4) and tuple(valid.shape) == (FRCNN_BATCH, 100),
          "frcnn e2e output shape")
    check(bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()),
          "frcnn e2e output is not finite")
    for name, least in (("preprocess", 1), ("roi_align", 1), ("nms", 2)):
        check(launches[name] >= least * iters,
              f"the Faster R-CNN run launched the {name} kernel {launches[name]} times "
              f"in {iters} calls")
    emit(phase="frcnn_e2e", batch=FRCNN_BATCH, img=IMG, num_classes=FRCNN_CLASSES,
         imgs_per_s=FRCNN_BATCH / dt, ms_per_batch=dt * 1e3,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         valid_detections=int(valid.sum()), launches=launches,
         launches_per_call={k: v / iters for k, v in launches.items()})

    from object_detectors_tpu_torch.analysis.frcnn_stages import stage_times

    stages = stage_times(pipe, batches, 5)
    emit(phase="frcnn_stages", batch=FRCNN_BATCH, ms=stages, stage_sum_ms=sum(stages.values()))

    # the kernels alone, at the path's own inputs
    m = pipe.model
    rpn = m.cfg.rpn
    with torch.inference_mode():
        x = P.preprocess_images(batches[0], torch.bfloat16).permute(0, 3, 1, 2)
        feats = m.backbone(x)
        obj, deltas, sizes = m.rpn_head(feats)
        props = m.decode(feats, deltas, (IMG, IMG))
        cand_boxes, cand_scores = RPN.level_candidates(props, obj.float(), sizes, (IMG, IMG), rpn)
        rois, _, roi_valid = RPN.filter_proposals(props, obj.float(), sizes, (IMG, IMG), rpn)
    maps = list(feats[:4])
    roi_err, staged = check_roi_align(KR, "Faster R-CNN path inputs", maps, rois)
    pooled = KR.multiscale_roi_align_cuda(maps, rois, (IMG, IMG))
    before, after = roi_gather_bytes(KR, maps, rois, staged)
    ms = cuda_ms(lambda: KR.multiscale_roi_align_cuda(maps, rois, (IMG, IMG)), 20)
    plain_ms = cuda_ms(lambda: KR.multiscale_roi_align_reference(maps, rois, (IMG, IMG)), 3)
    moved = (pooled.numel() * pooled.element_size()
             + sum(f.numel() * f.element_size() for f in maps) + rois.numel() * 4
             + rois.numel())  # boxes f32 and levels int32 read once
    ops = pooled.numel() * (8 * 2 * 2 + 1)  # 4 multiply-adds a sample, 4 samples, 1 divide
    bound, bound_by = time_bound(moved, ops)
    roi = dict(launches=launches["roi_align"], max_abs_err=roi_err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound, bound_by=bound_by,
               path_rois={"staged": int(staged.sum()), "direct": int((~staged).sum())})
    emit(phase="kernel_time", name="roi_align", out_shape=list(pooled.shape),
         valid_proposals=int(roi_valid.sum()), bytes=moved, operations=ops,
         launches_per_batch=launches["roi_align"] / iters, library_ms=None,
         achieved_tb_per_s=moved / (ms * 1e-3) / 1e12,
         l2_gather_bytes_counted_from_geometry={"before": before, "after": after},
         **{k: v for k, v in roi.items() if k not in ("launches", "max_abs_err")})

    n = rpn.pre_nms_top_n_test
    nb, ns = cand_boxes.reshape(-1, n, 4), cand_scores.reshape(-1, n)
    check_nms(KN, "RPN path candidates", nb, ns, rpn.nms_thresh, n)
    timings = {}
    for case, (b, s, thr, k) in {
            "RPN path candidates": (nb, ns, rpn.nms_thresh, n),
            "postprocess shape, clustered": (
                *[t.cuda() for t in clustered_candidates(4, FRCNN_BATCH, 1000)[:2]], 0.5, 100),
    }.items():
        t = nms_kernel_time(KN, b, s, thr, k)
        t["phases_ms"] = nms_phase_ms(KN, b, s, thr, k)
        timings[case] = t
        emit(phase="kernel_time", name="nms", case=case, groups=s.shape[0], n=s.shape[1], k=k,
             launches_per_batch=launches["nms"] / iters, library_ms=None, **t)
    nms = dict(launches=launches["nms"], max_abs_err=0.0,
               **{key: timings["RPN path candidates"][key] for key in MEASURED_NMS})
    return batches, launches, roi, nms


def phase_frcnn_consistency(PL, P, KR, KN, RPN, u8):
    allow = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(num_classes=FRCNN_CLASSES, img_size=IMG, dtype=torch.float32)
        models = {dev: PL.build_frcnn_pipeline_uint8(device=dev, **kw).model
                  for dev in ("cuda", "cpu")}
        outs = {}
        with torch.inference_mode():
            for dev, m in models.items():
                x = P.preprocess_images(u8.to(dev), torch.float32).permute(0, 3, 1, 2)
                feats = m.backbone(x)
                outs[dev] = (feats, *m.rpn_head(feats))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow
    (feats_g, obj_g, deltas_g, _), (feats_c, obj_c, deltas_c, sizes) = outs["cuda"], outs["cpu"]
    # f32 on both, but cuDNN and the CPU sum the convolutions in other orders
    pairs = [(f"P{i + 2}", g, c) for i, (g, c) in enumerate(zip(feats_g, feats_c))]
    pairs += [("objectness", obj_g, obj_c), ("deltas", deltas_g, deltas_c)]
    for what, g, c in pairs:
        g = g.cpu()
        emit(phase="frcnn_consistency", what=what, shape=list(c.shape),
             max_abs_err=(g - c).abs().max().item(), max_abs_ref=c.abs().max().item())
        torch.testing.assert_close(g, c, rtol=FEAT_RTOL, atol=FEAT_ATOL)

    m = models["cpu"]
    rpn = m.cfg.rpn
    with torch.inference_mode():
        props = m.decode(feats_c, deltas_c, (IMG, IMG))
        cand_boxes, cand_scores = RPN.level_candidates(props, obj_c.float(), sizes, (IMG, IMG),
                                                       rpn)
        rois, _, roi_valid = RPN.filter_proposals(props, obj_c.float(), sizes, (IMG, IMG), rpn)
        n = rpn.pre_nms_top_n_test
        nb, ns = cand_boxes.reshape(-1, n, 4), cand_scores.reshape(-1, n)
        keep_c, ok_c = KN.greedy_nms_reference(nb, ns, rpn.nms_thresh, n)
        pooled_c = KR.multiscale_roi_align_reference(list(feats_c[:4]), rois, (IMG, IMG))
    keep_g, ok_g = KN.greedy_nms_cuda(nb.cuda(), ns.cuda(), rpn.nms_thresh, n)
    identical = torch.equal(keep_g.cpu(), keep_c) and torch.equal(ok_g.cpu(), ok_c)
    emit(phase="frcnn_consistency", what="NMS kernel (GPU) vs plain (CPU), RPN candidates",
         groups=nb.shape[0], n=n, identical=identical, kept=int(ok_c.sum()),
         alive=int((ns > float("-inf")).sum()))
    check(identical, "NMS kernel on the GPU differs from the plain version on the CPU")
    pooled_g = KR.multiscale_roi_align_cuda([f.cuda() for f in feats_c[:4]], rois.cuda(),
                                            (IMG, IMG)).cpu()
    emit(phase="frcnn_consistency", what="RoIAlign kernel (GPU) vs plain (CPU), RPN proposals",
         shape=list(pooled_c.shape), valid_proposals=int(roi_valid.sum()),
         max_abs_err=(pooled_g - pooled_c).abs().max().item(),
         max_abs_ref=pooled_c.abs().max().item())
    torch.testing.assert_close(pooled_g, pooled_c, rtol=ROI_F32_RTOL, atol=ROI_F32_ATOL)


def fused_case(seed: int, b: int, h: int, w: int, cin: int, cm: int, down: bool):
    """A stride-1 Bottleneck (Cout = 4 Cm) on the card with seeded LeCun-scale
    weights and frozen statistics, and a seeded bf16 input in channels_last
    memory."""
    from object_detectors_tpu_torch.models.resnet import Bottleneck

    g = torch.Generator(device="cuda").manual_seed(seed)
    block = Bottleneck(cin, cm, 1, downsample=down).cuda().eval()
    with torch.no_grad():
        for t in block.parameters():
            t.copy_(torch.randn(t.shape, generator=g, device="cuda") * t[0].numel() ** -0.5)
        for name, t in block.named_buffers():
            low, high = FROZEN_RANGES[name.split(".")[-1]]
            t.copy_(low + (high - low) * torch.rand(t.shape, generator=g, device="cuda"))
    x = torch.randn(b, cin, h, w, generator=g, device="cuda").to(torch.bfloat16)
    return block, x.contiguous(memory_format=torch.channels_last)


def fused_bound(b, h, w, cin, cm, cout, down):
    """The least time of one fused block in ms and what sets it: x read and
    the output written once, the weights read once, against its tensor-core
    operations. Returns (ms, "bytes" or "operations", bytes, operations)."""
    pix = b * h * w
    macs = cin * cm + 9 * cm * cm + cm * cout + (cin * cout if down else 0)
    ops = 2 * pix * macs
    moved = pix * (cin + cout) * 2 + macs * 2 + (2 * cm + 2 * cout) * 4
    t = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "operations": ops / BF16_TC_OPS_PER_S * 1e3}
    by = max(t, key=t.get)
    return t[by], by, moved, ops


def fused_agreement(out: torch.Tensor, ref: torch.Tensor, small: bool):
    """The fused kernel's bf16 output against its plain version: (the largest
    difference in bf16 ulps of max(|ref|, 1) over the output, the share of
    elements not bitwise equal, whether both are within the limits; a small
    shape must be bitwise equal)."""
    _, exp = math.frexp(max(ref.float().abs().max().item(), 1.0))
    ulps = (out.float() - ref.float()).abs().max().item() / 2.0 ** (exp - 8)
    unequal = (bits(out) != bits(ref)).float().mean().item()
    return ulps, unequal, ulps <= FUSED_MAX_ULPS and (
        unequal == 0.0 if small else unequal < FUSED_UNEQUAL_SHARE)


def phase_fused_block_kernel(KF):
    """The kernel against its plain version (TF32 off); at the ResNet-50
    shapes also timed beside the plain version, the bound and the unfused
    cuDNN block. Returns (worst max abs difference, the times of the 13
    launches of one ResNet-50 forward at batch 16 with their bound, and the
    per-shape times)."""
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, timings = 0.0, []
    try:
        # (batch, H, W, Cin, Cm, Cout, projection, launches a forward, variant)
        cases = [(RETINA_BATCH, hh, hh, cin, cm, cout, down, n, 4)
                 for n, hh, cin, cm, cout, down in RESNET50_FUSED_BLOCKS]
        cases += [(3, 19, 23, 128, 128, 512, True, 0, 4), (1, 13, 7, 2048, 512, 2048, False, 0, 4),
                  (2, 14, 22, 32, 8, 32, True, 0, 2), (2, 16, 24, 32, 8, 32, False, 0, 2),
                  (2, 16, 24, 32, 8, 32, True, 0, 2)]
        for i, (b, h, w, cin, cm, cout, down, count, variant) in enumerate(cases):
            block, x = fused_case(100 + i, b, h, w, cin, cm, down)
            cfg = KF.launch_config(b, h, w, cin, cm, cout)
            check(cfg["variant"] == variant, f"the fused block took variant {cfg['variant']} at "
                                             f"{cases[i]}, not {variant}")
            with torch.inference_mode():
                prepared = block.prepared()
                args = prepared.folded
                out = KF.fused_block_cuda(x, prepared)
                ref = KF.fused_bottleneck_reference(x, *args)
                torch.cuda.synchronize()
                diff = out.float() - ref.float()
                err, mean = diff.abs().max().item(), diff.mean().item()
                ulps, unequal, agrees = fused_agreement(out, ref, small=variant == 2)
                worst = max(worst, err)
                line = dict(phase="kernel", name="fused_block",
                            shape=dict(batch=b, h=h, w=w, cin=cin, cm=cm, cout=cout,
                                       projection=down),
                            **cfg, waves=cfg["ctas"] / (sms * cfg["ctas_per_sm"]),
                            max_abs_err=err, mean_err=mean,
                            mean_abs_err=diff.abs().mean().item(), max_ulps=ulps,
                            not_bitwise_equal_share=unequal,
                            max_abs_ref=ref.float().abs().max().item())
                if count:
                    bound, by, moved, ops = fused_bound(b, h, w, cin, cm, cout, down)
                    weights = cin * cm + 9 * cm * cm + cm * cout + (cin * cout if down else 0)
                    t = dict(shape=line["shape"], count=count, variant=cfg["variant"],
                             cluster=cfg["cluster"],
                             tile=[cfg["tile_h"], cfg["tile_w"]], ctas=cfg["ctas"],
                             l2_weight_bytes=cfg["ctas"] * weights * 2,
                             bound_ms=bound, bound_by=by, bytes=moved, operations=ops,
                             ms=cuda_ms(lambda: KF.fused_block_cuda(x, prepared), 20),
                             plain_ms=cuda_ms(lambda: KF.fused_bottleneck_reference(x, *args), 3),
                             library_ms=cuda_ms(lambda: block(x), 20))
                    t["tflop_per_s"] = ops / (t["ms"] * 1e-3) / 1e12
                    timings.append(t)
                    line.update(t, library="unfused Bottleneck (cuDNN convs, FrozenBN, ReLU, add)")
                emit(**line)
            torch.testing.assert_close(out.float(), ref.float(), rtol=FUSED_RTOL, atol=FUSED_ATOL)
            check(abs(mean) < FUSED_MEAN, f"fused block mean difference {mean} at {cases[i]}")
            check(agrees, f"fused block {ulps} bf16 ulps off, {unequal} of the elements not "
                          f"bitwise equal at {cases[i]}")
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    # a forward's 13 launches, one after another: the sum over the five
    # shapes of count x each, the bound too; bound_by is what sets the larger
    # part of that sum
    per_forward = {key: sum(t["count"] * t[key] for t in timings)
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    part = {by: sum(t["count"] * t["bound_ms"] for t in timings if t["bound_by"] == by)
            for by in ("bytes", "operations")}
    per_forward["bound_by"] = max(part, key=part.get)
    return worst, per_forward, timings


def phase_retinanet_e2e(PL, P, KN, KF):
    """Unfused, then fused, on the same weights. Returns (batches, launches
    by mode)."""
    from object_detectors_tpu_torch.analysis.frcnn_stages import stage_times
    from object_detectors_tpu_torch.models.resnet import set_fused

    pipe = PL.build_retinanet_pipeline_uint8(num_classes=RETINA_CLASSES, img_size=IMG,
                                             device="cuda")
    rng = np.random.RandomState(1)
    batches = [torch.from_numpy(rng.randint(0, 255, (RETINA_BATCH, IMG, IMG, 3),
                                            dtype=np.uint8)).cuda() for _ in range(3)]
    counters = {"preprocess": P, "nms": KN, "fused_block": KF}
    iters, launches = 8, {}
    for mode in ("off", "auto"):
        set_fused(pipe.model, mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dt, (boxes, scores, labels, valid), launches[mode] = timed_calls(pipe, batches, counters,
                                                                         iters)
        det = pipe.cfg.detections_per_img
        check(tuple(boxes.shape) == (RETINA_BATCH, det, 4)
              and tuple(valid.shape) == (RETINA_BATCH, det), "retinanet e2e output shape")
        check(bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()),
              "retinanet e2e output is not finite")
        need = {"preprocess": 1, "nms": 1, "fused_block": 13 if mode == "auto" else 0}
        for name, per_call in need.items():
            check(launches[mode][name] == per_call * iters,
                  f"retinanet ({mode}) launched the {name} kernel {launches[mode][name]} "
                  f"times in {iters} calls, not {per_call * iters}")
        emit(phase="retinanet_e2e", backbone_fused=mode, batch=RETINA_BATCH, img=IMG,
             num_classes=RETINA_CLASSES, imgs_per_s=RETINA_BATCH / dt, ms_per_batch=dt * 1e3,
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             valid_detections=int(valid.sum()), launches=launches[mode],
             launches_per_call={k: v / iters for k, v in launches[mode].items()})
        stages = stage_times(pipe, batches, 5)
        emit(phase="retinanet_stages", backbone_fused=mode, batch=RETINA_BATCH, ms=stages,
             stage_sum_ms=sum(stages.values()))
    return batches, launches


def phase_frcnn_fused(PL, P, KF, u8):
    """frcnn640's backbone+FPN alone, unfused and fused, on the same weights
    and input, and the batch-norm fold: cold (every block's cache emptied:
    fold, kernel layout and TMA descriptors again) and warm (what a forward
    spends on it once the caches are built: nothing)."""
    from object_detectors_tpu_torch.models import resnet as R

    m = PL.build_frcnn_pipeline_uint8(num_classes=FRCNN_CLASSES, img_size=IMG,
                                      device="cuda").model
    blocks = [blk for blk in m.modules() if isinstance(blk, R.Bottleneck) and blk.stride == 1]

    def cold_fold():
        for blk in blocks:
            blk._prepared = None
            blk.prepared().operands()

    with torch.inference_mode():
        x = P.preprocess_images(u8, torch.bfloat16).permute(0, 3, 1, 2)
        feats, ms = {}, {}
        for mode in ("off", "auto"):
            R.set_fused(m, mode)
            KF.launches = 0
            feats[mode] = m.backbone(x)
            launches = KF.launches
            ms[mode] = cuda_ms(lambda: m.backbone(x), 10)
        check(launches == 13, f"the fused frcnn backbone launched the kernel {launches} times")
        check(len(blocks) == launches, "the stride-1 blocks are not the fused ones")
        fold_cold = cuda_ms(cold_fold, 10)
        # a warm forward: the blocks' caches are built; count the folds and
        # the bundles it makes
        cached = [blk.prepared() for blk in blocks]
        folds, fold_bn = [], R.fold_bn
        R.fold_bn = lambda *a, **k: folds.append(1) or fold_bn(*a, **k)
        try:
            warm = m.backbone(x)
        finally:
            R.fold_bn = fold_bn
        check(folds == [] and all(blk.prepared() is c for blk, c in zip(blocks, cached)),
              f"a warm fused forward folded {len(folds)} batch norms")
        check(all(torch.equal(a, b) for a, b in zip(warm, feats["auto"])),
              "a warm fused forward differs from the first")
        # what a warm forward spends on the fold: the device work of every
        # block's cache lookup (none expected), traced, and its host time
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for blk in blocks:
                blk.prepared()
            torch.cuda.synchronize()
        warm_kernels = [e for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA]
        fold_warm = sum(e.device_time for e in warm_kernels) / 1e3
        check(not warm_kernels, f"a warm cache lookup ran {len(warm_kernels)} kernels")
        t0 = time.perf_counter()
        for _ in range(10):
            for blk in blocks:
                blk.prepared()
        check_host_ms = (time.perf_counter() - t0) / 10 * 1e3
        for i, (a, b) in enumerate(zip(feats["auto"], feats["off"])):
            check(bool(torch.isfinite(a).all()), "fused frcnn backbone output is not finite")
            emit(phase="frcnn_fused", what=f"P{i + 2} fused vs unfused", shape=list(a.shape),
                 max_abs_diff=(a.float() - b.float()).abs().max().item(),
                 mean_abs_diff=(a.float() - b.float()).abs().mean().item(),
                 max_abs_ref=b.float().abs().max().item())
    result = dict(backbone_fpn_ms_off=ms["off"], backbone_fpn_ms_auto=ms["auto"],
                  fused_launches_per_forward=launches, fold_ms_cold=fold_cold,
                  fold_ms_warm=fold_warm, fold_launches_warm=len(warm_kernels),
                  folds_in_a_warm_forward=len(folds), cache_check_host_ms=check_host_ms)
    emit(phase="frcnn_fused", batch=u8.shape[0], **result)
    return result


def live_logits(seed: int, batch: int, anchors: int, classes: int):
    """Seeded bf16 logits around logit(0.05) = -2.94 (a few percent of the
    pairs pass, ties everywhere) and bf16 box deltas."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = (-4.2 + 0.7 * torch.randn(batch, anchors, classes, generator=g, device="cuda"))
    reg = 0.2 * torch.randn(batch, anchors, 4, generator=g, device="cuda")
    return logits.to(torch.bfloat16), reg.to(torch.bfloat16)


def phase_retinanet_post(RN, KN, pipe_anchors):
    """The postprocess on the card and on the CPU on the same live logits;
    then the NMS kernel alone at its inputs there. Returns the NMS timing."""
    from object_detectors_tpu_torch.models import anchors as anchor_lib

    cfg = RN.RetinaNetConfig(num_classes=RETINA_CLASSES)
    level_sizes = tuple(h * w * 9 for h, w in anchor_lib.fpn_grid_sizes((IMG, IMG)))
    logits, reg = live_logits(5, RETINA_BATCH, sum(level_sizes), RETINA_CLASSES)
    logit_thr = float(np.log(cfg.score_thresh / (1 - cfg.score_thresh)))
    passing = (logits.float() > logit_thr).sum(dim=(1, 2))
    with torch.inference_mode():
        gpu = RN.retinanet_postprocess(logits, reg, pipe_anchors, level_sizes, (IMG, IMG), cfg)
        cpu = RN.retinanet_postprocess(logits.cpu(), reg.cpu(), pipe_anchors.cpu(), level_sizes,
                                       (IMG, IMG), cfg)
    gpu = [t.cpu() for t in gpu]
    same = {name: torch.equal(g, c) for name, g, c in
            zip(("boxes", "scores", "labels", "valid"), gpu, cpu)}
    emit(phase="retinanet_post", logits=list(logits.shape), dtype=str(logits.dtype),
         passing_per_image_min=int(passing.min()), passing_per_image_max=int(passing.max()),
         valid=int(cpu[3].sum()), bitwise_equal=same,
         boxes_max_abs_diff=(gpu[0] - cpu[0]).abs().max().item(),
         scores_max_abs_diff=(gpu[1] - cpu[1]).abs().max().item())
    check(same["labels"] and same["valid"], "retinanet postprocess labels or order differ "
                                            "between the GPU and the CPU")
    check(int(cpu[3].sum()) > 0, "retinanet postprocess kept nothing on live logits")
    torch.testing.assert_close(gpu[0], cpu[0], rtol=0, atol=BOX_ATOL)
    torch.testing.assert_close(gpu[1], cpu[1], rtol=0, atol=SCORE_ATOL)

    # the NMS kernel alone at the inputs the GPU postprocess gave it
    def postprocess():
        with torch.inference_mode():
            RN.retinanet_postprocess(logits, reg, pipe_anchors, level_sizes, (IMG, IMG), cfg)

    with watched(KN, "greedy_nms_cuda") as calls:
        postprocess()
    check(len(calls) == 1, f"the postprocess called the NMS kernel {len(calls)} times")
    (b, s, thr, k, valid), _ = calls[0]
    check(valid is None, "the postprocess passed the NMS kernel a valid mask")
    check_nms(KN, "RetinaNet postprocess, live logits", b, s, thr, k)
    t = nms_kernel_time(KN, b, s, thr, k)
    t["phases_ms"] = nms_phase_ms(KN, b, s, thr, k)
    emit(phase="kernel_time", name="nms", case="RetinaNet postprocess, live logits",
         groups=s.shape[0], n=s.shape[1], k=k, live=int((s > float("-inf")).sum()),
         library_ms=None, **t)  # torchvision is not a dependency
    return {key: t[key] for key in MEASURED_NMS}


def phase_retinanet_consistency(PL, P, u8):
    allow = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        kw = dict(num_classes=RETINA_CLASSES, img_size=IMG, dtype=torch.float32)
        outs = {}
        with torch.inference_mode():
            for dev in ("cuda", "cpu"):
                m = PL.build_retinanet_pipeline_uint8(device=dev, **kw).model
                outs[dev] = m(P.preprocess_images(u8.to(dev), torch.float32))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = allow
    # f32 on both, but cuDNN and the CPU sum the convolutions in other orders
    for what, g, c in (("cls_logits", outs["cuda"][0], outs["cpu"][0]),
                       ("bbox_reg", outs["cuda"][1], outs["cpu"][1])):
        g = g.cpu()
        emit(phase="retinanet_consistency", what=what, shape=list(c.shape),
             max_abs_err=(g - c).abs().max().item(), max_abs_ref=c.abs().max().item())
        torch.testing.assert_close(g, c, rtol=FEAT_RTOL, atol=FEAT_ATOL)
    check(outs["cuda"][2] == outs["cpu"][2], "level sizes differ between devices")


def phase_serving(B, S, P, KN):
    """The bench's serving row: 256 requests, YOLO and RetinaNet at 4:1,
    flushes of 64 and 16 from a 32-image pool on the card. Every response
    against its flush's batch recomputed through its pipeline; one flush of
    each model dispatched under the sync debug mode. Returns (images/s,
    launches by kernel, candidates of the first YOLO flush's batch)."""
    log = []
    flush = S.BatchedDetectionServer._flush

    def watched(self, model):
        q = self.queues[model]
        reqs = [q[i][0] for i in range(min(len(q), self.batch_size[model]))]
        log.append((model, [r.request_id for r in reqs], [r.image for r in reqs]))
        return flush(self, model)

    S.BatchedDetectionServer._flush = watched
    P.launches = KN.launches = 0
    try:
        ips, out, server = B.run_serving()
    finally:
        S.BatchedDetectionServer._flush = flush
    launches = {"preprocess": P.launches, "nms": KN.launches}
    flushes = dict(server.flushes)  # the timed stream's
    for name, n in launches.items():
        check(n == len(log), f"serving launched the {name} kernel {n} times in {len(log)} "
                             f"flushes")
    ids = {r.request_id for r in out}
    check(len(out) == len(ids) == 256, f"serving answered {len(out)} requests, "
                                       f"{len(ids)} distinct")
    # each response against its row of its flush's batch recomputed: the same
    # card, the same batch shape
    by_id = {r.request_id: r for r in out}
    timed = log[len(log) - sum(flushes.values()):]
    unequal = dict.fromkeys(server.pipelines, 0)
    candidates = None
    for model, rids, slots in timed:
        bs = server.batch_size[model]
        idx = torch.tensor(slots + slots[-1:] * (bs - len(slots)), device="cuda")
        batch = server.pool.index_select(0, idx)
        boxes, scores, labels, valid = [t.cpu().numpy() for t in server.pipelines[model](batch)]
        if model == "yolo" and candidates is None and len(slots) == bs:
            candidates = server.pipelines[model].candidates(batch)
        for i, rid in enumerate(rids):
            r = by_id[rid]
            same = (np.array_equal(r.boxes.view(np.int32), boxes[i].view(np.int32))
                    and np.array_equal(r.scores.view(np.int32), scores[i].view(np.int32))
                    and np.array_equal(r.labels, labels[i]) and np.array_equal(r.valid, valid[i]))
            unequal[model] += not same
    # one flush of each model under the sync debug mode: no host sync
    syncs = {}
    for model, bs in server.batch_size.items():
        for i in range(bs):
            server.submit(S.Request(10_000 + i, model, i % 32))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                server._flush(model)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[model] = sum("called a synchronizing CUDA operation" in str(w.message)
                           for w in caught)
        server.drain()
    latency = np.array([r.latency_s for r in out])
    emit(phase="serving", requests=len(out), distinct_request_ids=len(ids), imgs_per_s=ips,
         latency_p50_s=float(np.percentile(latency, 50)),
         latency_p99_s=float(np.percentile(latency, 99)), flushes=flushes,
         flush_sizes={m: [len(f[1]) for f in timed if f[0] == m] for m in server.pipelines},
         launches=launches, flushes_with_warm_up=len(log),
         valid_detections={m: int(sum(r.valid.sum() for r in out if r.model == m))
                           for m in server.pipelines},
         rows_not_equal_to_the_recomputed_batch=unequal, host_syncs_in_a_flush=syncs)
    check(not any(unequal.values()), f"serving responses differ from their flushes' batches "
                                     f"recomputed: {unequal}")
    check(not any(syncs.values()), f"a serving flush synchronized with the host: {syncs}")
    check(candidates is not None, "serving ran no full YOLO flush")
    return ips, launches, candidates


def phase_yolo_lvis(B, PL, N, P, KN):
    """The bench's yolo_lvis416 row, then its candidates at batch 16, and two
    images in f32 (TF32 off) on the GPU and the CPU: raw maps within
    RAW_RTOL, nms_majority identical. Returns (launches by kernel, the
    candidates)."""
    P.launches = KN.launches = 0
    ips, mfu = B.run_yolo_lvis()
    launches = {"preprocess": P.launches, "nms": KN.launches}
    calls = 2 + 8 + 1  # warm-up, timed, and the one FlopCounterMode counts
    emit(phase="yolo_lvis416", batch=LVIS_BATCH, img=LVIS_IMG, num_classes=LVIS_CLASSES,
         imgs_per_s=ips, ms_per_batch=LVIS_BATCH / ips * 1e3, mfu=mfu, calls=calls,
         launches=launches)
    for name, n in launches.items():
        check(n == calls, f"yolo_lvis416 launched the {name} kernel {n} times in {calls} calls")
    kw = dict(topk=300, max_det=300)
    u8 = torch.from_numpy(np.random.RandomState(3).randint(
        0, 255, (LVIS_BATCH, LVIS_IMG, LVIS_IMG, 3), dtype=np.uint8)).cuda()
    candidates = PL.build_pipeline_uint8(LVIS_CLASSES, LVIS_IMG, **kw).candidates(u8)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kw.update(dtype=torch.float32)
        gpu = PL.build_pipeline_uint8(LVIS_CLASSES, LVIS_IMG, device="cuda", **kw)
        cpu = PL.build_pipeline_uint8(LVIS_CLASSES, LVIS_IMG, device="cpu", **kw)
        raw_gpu = [o.cpu() for o in gpu.raw_outputs(u8[:2])]
        raw_cpu = cpu.raw_outputs(u8[:2].cpu())
        for g, c in zip(raw_gpu, raw_cpu):
            emit(phase="yolo_lvis416", what="raw, f32 GPU vs CPU", shape=list(g.shape),
                 max_abs_err=(g - c).abs().max().item(), max_abs_ref=c.abs().max().item())
            torch.testing.assert_close(g, c, rtol=RAW_RTOL, atol=RAW_ATOL)
        boxes, scores, labels, valid = gpu.candidates(u8[:2])
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    same_nms(N, "yolo_lvis416", "f32 candidates of two images", boxes, scores, labels, valid,
             LVIS_CLASSES, 300)
    return launches, candidates


def phase_nms_majority(N, KN, cases):
    """nms_majority on the card at the YOLO paths' shapes and the bench's
    three distributions: identical to the scan method and to the port on
    the CPU, one NMS kernel launch a call and no host sync under the sync
    debug mode; its time (CUDA events) beside the scan's, and the kernel's
    at the call's inputs beside its bound. Returns the kernel's timings."""
    timings = {}
    for case, (b, s, c, v, classes, k) in cases.items():
        def call(method="fixedpoint"):
            return N.nms_majority(b, s, c, classes, 0.6, k, valid=v, method=method)

        call()
        torch.cuda.synchronize()
        before = KN.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            fixed = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches = KN.launches - before
        scan = call("scan")
        cpu = N.nms_majority(b.cpu(), s.cpu(), c.cpu(), classes, 0.6, k,
                             valid=None if v is None else v.cpu())
        same_scan = all(torch.equal(x, y) for x, y in zip(fixed, scan))
        same_cpu = all(torch.equal(x.cpu(), y) for x, y in zip(fixed, cpu))
        with watched(KN, "greedy_nms_cuda") as calls:
            call()
        (kb, ks, thr, kk, kv), _ = calls[0]
        t = nms_kernel_time(KN, kb, ks, thr, kk, kv)
        timings[case] = {key: t[key] for key in MEASURED_NMS if key in t}
        emit(phase="nms_majority", case=case, groups=s.shape[0], n=s.shape[1],
             num_classes=classes, max_output=k, identical_to_scan=same_scan,
             identical_to_cpu=same_cpu, kernel_launches_a_call=launches,
             kept=int(fixed[3].sum()), ms=cuda_ms(call, 20),
             scan_ms=cuda_ms(lambda: call("scan"), 3), kernel=t)
        check(launches == 1, f"nms_majority launched the NMS kernel {launches} times ({case})")
        check(same_scan and same_cpu, f"nms_majority differs from the scan or from the CPU "
                                      f"({case})")
        check(int(fixed[3].sum()) > 0, f"nms_majority kept nothing ({case})")
    return timings


def phase_nms_latency(B, KN):
    """The bench's nms_p50_latency row. Returns the NMS kernel's launches."""
    KN.launches = 0
    res = B.run_nms_latency()
    launches = KN.launches
    emit(phase="nms_latency", batch=512, candidates=256, num_classes=80, max_output=100,
         us_per_image=res, launches=launches)
    check(launches == 3 * (3 + 7 * 20), f"nms_p50_latency launched the NMS kernel {launches} "
                                        f"times")
    return launches


def phase_yolo_neck(PL, u8):
    """Full-width YOLOv3-SPP and YOLOv3 with the FPN neck (80 classes,
    seeded random weights) on two 320² images in f32 (TF32 off): raw maps on
    the GPU and the CPU within RAW_RTOL."""
    from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_

    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, head in (("YOLOv3-SPP", dict(use_spp=True)), ("FPN neck", dict(use_fpn=True))):
            model = init_yolo_(YoloHead(NUM_CLASSES, 3, **head))
            raw = {dev: [o.cpu() for o in PL.build_pipeline(
                NUM_CLASSES, u8.shape[1], dtype=torch.float32, model=model, device=dev,
                uint8=True).raw_outputs(u8.to(dev))] for dev in ("cuda", "cpu")}
            for g, c in zip(raw["cuda"], raw["cpu"]):
                emit(phase="yolo_neck", what=name, shape=list(g.shape),
                     max_abs_err=(g - c).abs().max().item(), max_abs_ref=c.abs().max().item())
                torch.testing.assert_close(g, c, rtol=RAW_RTOL, atol=RAW_ATOL)
    finally:
        torch.backends.cudnn.allow_tf32 = allow


def roi_backward_case(seed: int, b: int, n: int, size: int, c: int, dtype, out=(7, 7)):
    """Seeded R50-FPN level shapes (P2-P5 of a ``size``² image), RoIs and an
    output cotangent [b, n, *out, c] in ``dtype`` on the card."""
    shapes = [(b, c, size // s, size // s) for s in (4, 8, 16, 32)]
    g = torch.Generator(device="cuda").manual_seed(seed)
    cot = torch.randn(b, n, *out, c, generator=g, device="cuda").to(dtype)
    return shapes, random_rois(seed, b, n, size), cot


def roi_backward_work(shapes, boxes, cot, size, s=2):
    """(bytes, operations, atomics) of one backward on these inputs: the
    cotangent and boxes read once and the level maps' cotangents written
    once; for every sample inside its map and channel, four weights, four
    products and four atomic adds (the corner updates), and a divide per bin
    and channel."""
    c = cot.shape[-1]
    inside = int(inside_samples([sh[2:] for sh in shapes], boxes, size, cot.shape[2:4],
                                s).sum())
    moved = (cot.numel() * cot.element_size() + boxes.numel() * 4
             + sum(int(np.prod(sh)) for sh in shapes) * cot.element_size())
    return moved, inside * c * 12 + cot.numel(), inside * c * 4


def check_roi_backward(KR, KB, case, shapes, boxes, cot, size):
    """Kernel vs plain backward on one input: f32 within ROI_F32_*, bf16
    within one bf16 ulp of max(|plain|, 1); each RoI's route (level; staged
    and summed a footprint pixel at a time, or its samples' corners reduced
    directly) against ``assign_fpn_levels`` and the rule ``backward_routes``
    states. The reductions' change of order errs in proportion to the
    values summed, so where the cotangent and the result lie below 1 (a
    training step's do, by orders) the absolute tolerance shrinks with the
    larger of their largest values. Returns the max abs error."""
    from object_detectors_tpu_torch.ops.roi_align import assign_fpn_levels

    dtype = cot.dtype
    out_size = tuple(cot.shape[2:4])
    route = torch.empty(boxes.shape[:2], dtype=torch.uint8, device="cuda")
    got = KB.multiscale_roi_align_backward_cuda(cot, boxes, shapes, (size, size), out_size,
                                                dtype=dtype, route=route)
    ref = KB.multiscale_roi_align_backward_reference(cot, boxes, shapes, (size, size),
                                                     out_size, dtype=dtype)
    rule, foot = KR.backward_routes(shapes, boxes, (size, size), out_size)
    levels = torch.equal((route // 2).int(), assign_fpn_levels(boxes, len(shapes)))
    staged = (route % 2).bool()
    torch.cuda.synchronize()
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    ulp_ok = all(bool(((g.float() - r.float()).abs()
                       <= (r.float().abs().clamp(min=1.0).log2().floor() - 7).exp2()).all())
                 for g, r in zip(got, ref))
    emit(phase="kernel", name="roi_align_backward", case=case, dtype=str(dtype),
         cotangent_shape=list(cot.shape), level_shapes=[list(sh) for sh in shapes],
         max_abs_err=err, max_abs_ref=max(r.float().abs().max().item() for r in ref),
         max_abs_cotangent=cot.float().abs().max().item(),
         within_one_bf16_ulp_of_max_plain_1=ulp_ok,
         channels_last=all(g.is_contiguous(memory_format=torch.channels_last) for g in got),
         staged_rois=int(staged.sum()), direct_rois=int((~staged).sum()),
         footprint_max=int(foot.max()) if foot.numel() else 0,
         levels_as_assign_fpn_levels=levels, route_as_the_rule_says=torch.equal(staged, rule))
    scale = min(1.0, max([cot.float().abs().max().item()]
                         + [r.float().abs().max().item() for r in ref]))
    for g, r in zip(got, ref):
        check(g.dtype == dtype and g.shape == r.shape, f"RoIAlign backward output ({case})")
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=ROI_F32_RTOL, atol=ROI_F32_ATOL * scale)
    check(dtype == torch.float32 or ulp_ok,
          f"bf16 RoIAlign backward is not within one ulp of max(|plain|, 1) ({case})")
    check(levels, f"RoIAlign backward took other levels than assign_fpn_levels ({case})")
    check(torch.equal(staged, rule), f"RoIAlign backward took other routes than the rule "
                                     f"says ({case})")
    return err


def roi_backward_time(KR, KB, shapes, boxes, cot, size, iters=20):
    """One backward timed at these inputs (ms): the wrapper with CUDA events
    (the f32 buffer's zeroing, the kernel and, in bf16, its rounding pass),
    the zeroing alone, and from a torch.profiler trace of the wrapper the
    device time of each part: the zeroing, the kernel (``kernel_only_ms``)
    and the rounding. With the reductions the kernel issues
    (``backward_reductions``, counted on the host) beside the corner
    updates of a scatter, and its staged and direct RoIs as the kernel's
    route bytes give them."""
    dtype = cot.dtype
    total = sum(int(np.prod(sh)) for sh in shapes)
    out_size = tuple(cot.shape[2:4])
    args = (cot, boxes, shapes, (size, size), out_size, 2)
    t = dict(ms=cuda_ms(lambda: KB.multiscale_roi_align_backward_cuda(*args, dtype=dtype),
                        iters),
             zeroing_ms=cuda_ms(lambda: torch.zeros(total, dtype=torch.float32,
                                                    device="cuda"), iters))
    parts = {"roi_align_backward_kernel": "kernel", "round_to_bf16_kernel": "rounding"}
    events = device_events(lambda: KB.multiscale_roi_align_backward_cuda(*args, dtype=dtype),
                           iters)
    if events:
        device = {"kernel": 0.0, "rounding": 0.0, "zeroing": 0.0}
        for e in events:
            part = next((v for key, v in parts.items() if key in e.name), "zeroing")
            device[part] += e.device_time / 1e3 / iters
        check(device["kernel"] > 0, f"the RoIAlign backward trace misses its kernel: {device}")
        kernel_only = device["kernel"]
    else:
        # every trace came back empty: the CUDA events' wrapper time less the
        # zeroing's, which holds the rounding pass too in bf16
        device = {"kernel": "not measured", "rounding": "not measured",
                  "zeroing": "not measured", "kernel_only_ms_from": "CUDA events: ms - zeroing_ms"}
        kernel_only = t["ms"] - t["zeroing_ms"]
        emit(phase="trace", what="RoIAlign backward parts", note="every trace came back empty")
    route = torch.empty(boxes.shape[:2], dtype=torch.uint8, device="cuda")
    KB.multiscale_roi_align_backward_cuda(*args, dtype=dtype, route=route)
    staged = (route % 2).bool()
    moved, ops, atomics = roi_backward_work(shapes, boxes, cot, size)
    bound, bound_by = time_bound(moved, ops)
    return dict(t, device_ms=device, kernel_only_ms=kernel_only, bound_ms=bound,
                bound_by=bound_by, bytes=moved, operations=ops, atomics=atomics,
                global_reductions=KR.backward_reductions(shapes, boxes, (size, size), out_size),
                staged_rois=int(staged.sum()), direct_rois=int((~staged).sum()))


def phase_roi_align_backward_kernel(KR, KB):
    """The backward kernel against its plain version (f32 and bf16) at the
    Faster R-CNN training shape, [2, 512, 7, 7, 256] on P2-P5 of an 800²
    image, at an odd one and at a 14x14 one; then timed at the training
    shape in f32, the dtype Faster R-CNN trains in, and in bf16."""
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        cases = {"Faster R-CNN training shape": (roi_backward_case(0, 2, 512, 800, 256, dtype),
                                                 800),
                 "odd: 3 x 37 RoIs, C=20, 224²": (roi_backward_case(1, 3, 37, 224, 20, dtype),
                                                  224),
                 "14x14: 2 x 64 RoIs, C=256, 800²": (
                     roi_backward_case(2, 2, 64, 800, 256, dtype, (14, 14)), 800)}
        for case, ((shapes, boxes, cot), size) in cases.items():
            worst = max(worst, check_roi_backward(KR, KB, case, shapes, boxes, cot, size))
        shapes, boxes, cot = cases["Faster R-CNN training shape"][0]
        t = roi_backward_time(KR, KB, shapes, boxes, cot, 800)
        plain_ms = cuda_ms(lambda: KB.multiscale_roi_align_backward_reference(
            cot, boxes, shapes, (800, 800), dtype=dtype), 2)
        timing[str(dtype)] = dict(plain_ms=plain_ms, **{
            key: t[key] for key in ("ms", "bound_ms", "bound_by", "zeroing_ms",
                                    "kernel_only_ms", "device_ms", "staged_rois",
                                    "direct_rois")})
        emit(phase="kernel_time", name="roi_align_backward", dtype=str(dtype),
             case="synthetic RoIs (random_rois)", cotangent_shape=list(cot.shape),
             reductions_per_s=t["global_reductions"] / (t["kernel_only_ms"] * 1e-3),
             library_ms=None, plain_ms=plain_ms, **t)
    return worst, timing


def tf32_state():
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def check_update_gap(TS, phase, what, models, before, worst_share=None, norm_share=None):
    """The parameter updates of a tiny step on the GPU against the CPU
    (``tiny_steps.update_gap``), each tensor's largest difference as a
    share of its largest update (at least NULL_UPDATE_SHARE of the largest
    update of any tensor) at most ``worst_share``, the difference's norm as
    a share of the update's at most ``norm_share``."""
    gap = TS.update_gap(models, before)
    emit(phase=phase, what=f"{what}: GPU vs CPU parameter updates", **gap,
         worst_share_tolerance=worst_share, norm_share_tolerance=norm_share)
    check(worst_share is None or gap["worst_share"] <= worst_share,
          f"{phase}: GPU update of {gap['at']} off by {gap['worst_share']:.3g} of its largest "
          f"update")
    check(norm_share is None or gap["norm_share"] <= norm_share,
          f"{phase}: GPU updates off by {gap['norm_share']:.3g} of their norm")


def phase_yolo_train(B):
    """yolo_train416 (the port bench's row) and the tiny Darknet step of
    ``tiny_steps`` at 96 px in f32 and f64 (TF32 off) on the GPU against
    the CPU."""
    from object_detectors_tpu_torch.train import tiny_steps as TS

    emit(phase="yolo_train", tf32=tf32_state())
    t = B.train_step_timing()
    check(math.isfinite(t["loss"]), "yolo_train416 loss is not finite")
    emit(phase="yolo_train", row="yolo_train416", batch=128, img=416, **t)

    for dtype in (torch.float32, torch.float64):
        models, before, metrics = TS.yolo_step_on_both(dtype)
        what = f"tiny Darknet 96 px, {dtype}"
        for key in ("loss", "sub_losses", "stats"):
            g, c = metrics["cuda"][key].cpu(), metrics["cpu"][key]
            emit(phase="yolo_train", what=f"{what}, GPU vs CPU {key}",
                 max_abs_err=(g - c).abs().max().item(), max_abs_ref=c.abs().max().item())
            torch.testing.assert_close(g, c, rtol=TS.TRAIN_LOSS_RTOL, atol=1e-6)
        if dtype == torch.float32:
            check_update_gap(TS, "yolo_train", what, models, before,
                             norm_share=TS.YOLO_F32_UPDATE_NORM)
        else:
            check_update_gap(TS, "yolo_train", what, models, before,
                             worst_share=TS.YOLO_F64_UPDATE_SHARE)
    return t


def check_frcnn_train_kernels(KR, KB, KN, step, case="frcnn_train800"):
    """Each kernel of a Faster R-CNN training step against its plain
    version at the inputs that step gave it: the RPN filter's NMS (B x 5
    groups of up to 2000, K 2000, IoU 0.7) identical, the RoIAlign forward
    (f32 maps, 512 RoIs an image) within ROI_F32_*, its backward within
    ROI_F32_* too. Returns the NMS kernel's timing at its call's inputs and
    the backward's (f32 and bf16) at the step's own cotangent and RoIs."""
    with (watched(KN, "greedy_nms_cuda") as nms, watched(KR, "multiscale_roi_align_cuda") as fwd,
          watched(KB, "multiscale_roi_align_backward_cuda") as bwd):
        step()
    calls = {"nms": nms, "roi_align": fwd, "roi_align_bwd": bwd}
    for name, seen in calls.items():
        check(len(seen) == 1, f"a {case} step called the {name} kernel {len(seen)} "
                              f"times")
    (b, sc, thr, k, valid), _ = calls["nms"][0]
    check_nms(KN, f"{case} RPN filter, a step's own candidates", b, sc, thr, k, valid)
    t = nms_kernel_time(KN, b, sc, thr, k, valid)
    emit(phase="kernel_time", name="nms", case=f"{case} RPN filter", groups=sc.shape[0],
         n=sc.shape[1], max_output=k, iou_threshold=thr, **t)
    (maps, boxes, size, out, ratio), _ = calls["roi_align"][0]
    check(ratio == 2 and size[0] == size[1], f"{case} pooled at {size}, ratio {ratio}")
    check_roi_align(KR, f"{case}, a step's own maps and sampled RoIs", maps, boxes,
                    size[0], out)
    (cot, bboxes, shapes, bsize, bout, bratio, dtype), _ = calls["roi_align_bwd"][0]
    check(bout == (7, 7) and bratio == 2 and dtype == cot.dtype,
          f"{case}'s RoIAlign backward at {bout}, ratio {bratio}, {dtype}")
    check(torch.equal(bboxes, boxes), "the RoIAlign backward took other boxes than its forward")
    check_roi_backward(KR, KB, f"{case}, a step's own cotangent and RoIs", shapes,
                       bboxes, cot, bsize[0])
    own = {}
    for dtype in (torch.float32, torch.bfloat16):
        own[str(dtype)] = roi_backward_time(KR, KB, shapes, bboxes, cot.to(dtype), bsize[0])
        emit(phase="kernel_time", name="roi_align_backward", dtype=str(dtype),
             case=f"{case}, a step's own cotangent and RoIs",
             cotangent_shape=list(cot.shape), **own[str(dtype)])
    return t, own


def phase_frcnn_train(KR, KB, KN):
    """frcnn_train800: R50-FPN Faster R-CNN, 91 classes, 800², batch 2, RPN
    2000/2000, 512 RoIs a image, f32, SGD at lr 0.0025 with momentum 0.9,
    weight decay 1e-4, linear warmup (1000 steps from 1/1000) and the
    multistep decay at epochs 16 and 22: 2 warm-up steps, then timed steps
    whose kernel launches are counted; then one more step whose kernels
    are held against their plain versions at that step's inputs, and the
    tiny Faster R-CNN step of ``tiny_steps`` at 64 px on the GPU against
    the CPU with the same draws."""
    from object_detectors_tpu_torch.analysis.train_stages import FRCNN_BATCH, frcnn_train_setup
    from object_detectors_tpu_torch.train import tiny_steps as TS
    from object_detectors_tpu_torch.train import trainer

    emit(phase="frcnn_train", tf32=tf32_state())
    state, batches = frcnn_train_setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i in range(2):
        _, total, _ = trainer.frcnn_train_step(state, *batches[i % 3], generator=gen)
    float(total)  # host read
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    KR.launches = KB.launches = KN.launches = 0
    t0 = time.perf_counter()
    for i in range(iters):
        _, total, losses = trainer.frcnn_train_step(state, *batches[i % 3], generator=gen)
    last = float(total)  # one final host read
    dt = (time.perf_counter() - t0) / iters
    launches = {"roi_align": KR.launches, "roi_align_bwd": KB.launches, "nms": KN.launches}
    losses = {k: v.item() for k, v in losses.items()}
    emit(phase="frcnn_train", row="frcnn_train800", batch=FRCNN_BATCH, img=800,
         ms_per_step=dt * 1e3, imgs_per_s=FRCNN_BATCH / dt,
         loss=last, losses=losses,
         lr_last_step=state.optimizer.schedule(state.optimizer.count - 1),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
         launches_per_step={k: v / iters for k, v in launches.items()})
    check(math.isfinite(last) and all(math.isfinite(v) for v in losses.values()),
          "frcnn_train800 losses are not finite")
    for name in ("roi_align", "roi_align_bwd", "nms"):
        check(launches[name] == iters, f"frcnn_train800 launched the {name} kernel "
                                       f"{launches[name]} times in {iters} steps")
    nms_time, bwd_own = check_frcnn_train_kernels(
        KR, KB, KN, lambda: trainer.frcnn_train_step(state, *batches[iters % 3], generator=gen))

    models, before, tiny, tiny_launches = TS.frcnn_step_on_both()
    for k, v in tiny["cpu"].items():
        emit(phase="frcnn_train", what=f"tiny Faster R-CNN 64 px, GPU vs CPU {k}",
             gpu=tiny["cuda"][k].item(), cpu=v.item())
        torch.testing.assert_close(tiny["cuda"][k].cpu(), v, rtol=TS.FRCNN_LOSS_RTOL, atol=1e-6)
    check(tiny_launches == {"cpu": (0, 0, 0), "cuda": (1, 1, 1)},
          f"the tiny Faster R-CNN step's RoIAlign forward, backward and NMS launches: "
          f"{tiny_launches}")
    check_update_gap(TS, "frcnn_train", "tiny Faster R-CNN 64 px", models, before,
                     worst_share=TS.FRCNN_UPDATE_SHARE)
    return dict(ms_per_step=dt * 1e3, launches=launches, nms=nms_time, roi_align_bwd=bwd_own)

def protocol_f32_batch(B, PL, N, E, D):
    """The protocol's first 8 images through the full-width pipeline in f32
    (TF32 off) on the GPU and on the CPU. Gates: raw maps within RAW_RTOL;
    ``nms_majority`` on the GPU's candidates identical on both devices; the
    evaluator fed the card's NMS output and the CPU's of those candidates:
    result lists identical, stats within 1e-6. The two devices' whole
    pipelines: the same (image, category) results, the boxes of each such
    group within RAW_ATOL carried through the decode (below), stats within
    1e-6; their order is not compared (with 100 detections an image,
    scores a few ulps apart swap neighbours). Returns the detections."""

    gt, ds = B.protocol_set(PROTOCOL_IMAGES, PROTOCOL_IMG)
    batches = D.yolo_batches(ds, 8, PROTOCOL_IMG, max_boxes=8)
    batch = next(batches)
    batches.close()
    x = torch.from_numpy(batch["images"])
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kw = dict(img_size=PROTOCOL_IMG, dtype=torch.float32)
        gpu = PL.build_pipeline(device="cuda", **kw)
        cpu = PL.build_pipeline(device="cpu", **kw)
        for g, c in zip(gpu.raw_outputs(x.cuda()), cpu.raw_outputs(x)):
            g = g.cpu()
            emit(phase="protocol", what="raw, f32 GPU vs CPU", shape=list(g.shape),
                 max_abs_err=(g - c).abs().max().item(), max_abs_ref=c.abs().max().item())
            torch.testing.assert_close(g, c, rtol=RAW_RTOL, atol=RAW_ATOL)
        candidates = gpu.candidates(x.cuda())
        pipelines = {"cuda": gpu.nms(*candidates), "cpu": cpu(x)}
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    on_gpu, _ = same_nms(N, "protocol", "f32 candidates of 8 protocol images", *candidates)
    on_cpu = N.nms_majority(*(t.cpu() for t in candidates[:3]), NUM_CLASSES, 0.6, 100,
                            valid=candidates[3].cpu())

    def evaluate(out):
        ev = E.DetectionEvaluator(gt, label_map=lambda c: c + 1)
        ev.update(batch["image_ids"], *out, batch["scale_factors"])
        return ev.results, ev.summarize()

    (res_g, stats_g), (res_c, stats_c) = evaluate(on_gpu), evaluate(on_cpu)
    gap = float(np.abs(stats_g - stats_c).max())
    emit(phase="protocol", what="8 images in f32: evaluator on the card's NMS output vs the "
                                "CPU's, same candidates", detections=len(res_c),
         identical_results=res_g == res_c, stats_max_abs_diff=gap, map=float(stats_g[0]))
    check(res_g == res_c, "the evaluator's results differ between the card's NMS output "
                          "and the CPU's")
    check(gap <= 1e-6, f"GPU and CPU stats differ by {gap}")

    (res_g, stats_g), (res_c, stats_c) = (evaluate(pipelines[d]) for d in ("cuda", "cpu"))

    def grouped(res):
        """{(image, category): its boxes in sorted order}."""
        out = {}
        for r in res:
            out.setdefault((r["image_id"], r["category_id"]), []).append(r["bbox"])
        return {k: sorted(v) for k, v in out.items()}

    groups = {dev: grouped(res) for dev, res in (("cuda", res_g), ("cpu", res_c))}
    same = {k: len(v) for k, v in groups["cuda"].items()} == \
        {k: len(v) for k, v in groups["cpu"].items()}
    # RAW_ATOL of a raw logit moves a decoded center by at most stride / 4
    # (8 px at stride 32) times it, and a side by its length times it (exp):
    # each xywh value within RAW_ATOL * (8 + the box's longer side)
    box_err, box_share = 0.0, 0.0
    if same:
        for k, boxes in groups["cpu"].items():
            c = torch.tensor(boxes, dtype=torch.float64)
            err = (torch.tensor(groups["cuda"][k], dtype=torch.float64) - c).abs()
            tol = RAW_ATOL * (8 + c[:, 2:].amax(1, keepdim=True))
            box_err = max(box_err, err.max().item())
            box_share = max(box_share, (err / tol).max().item())
    gap = float(np.abs(stats_g - stats_c).max())
    emit(phase="protocol", what="8 images in f32: GPU pipeline vs CPU pipeline",
         detections=[len(res_g), len(res_c)], same_image_category_results=same,
         same_order=[(r["image_id"], r["category_id"]) for r in res_g]
         == [(r["image_id"], r["category_id"]) for r in res_c],
         box_max_abs_diff=box_err, box_max_share_of_tolerance=box_share,
         stats_max_abs_diff=gap, map=[float(stats_g[0]), float(stats_c[0])])
    check(same, "the GPU and CPU pipelines kept other (image, category) results")
    check(box_share <= 1.0, f"a box differs between the GPU and CPU pipelines by "
                            f"{box_share:.3g} of its tolerance")
    check(gap <= 1e-6, f"the GPU and CPU pipelines' stats differ by {gap}")
    return len(res_c)


def phase_protocol(B, PL, N, KN):
    """The port bench's ``run_protocol`` in its seeded branch at full width
    (Darknet-53, 80 classes, 416², bf16; 256 images; the ladder 2 to 128),
    one run a batch size (the CLI runs two; one keeps the phase within the
    time limit), the NMS kernel's launches counted over it: one a pipeline
    call. Then ``protocol_f32_batch``. Returns the launches."""
    from object_detectors_tpu_torch.data import coco as D
    from object_detectors_tpu_torch.eval import evaluator as E

    out_csv = "chiprun_out/protocol_rows.csv"
    KN.launches = 0
    t0 = time.perf_counter()
    rows = B.run_protocol(runs=1, out_csv=out_csv)
    seconds = time.perf_counter() - t0
    launches = KN.launches
    calls = sum(1 + math.ceil(PROTOCOL_IMAGES / bs) for bs in B.PROTOCOL_LADDER)
    for row in rows:
        emit(phase="protocol", **row,
             host_batching_and_eval_share=(row["app_time"] - row["forw_time"])
             / row["app_time"])
    emit(phase="protocol", images=PROTOCOL_IMAGES, img=PROTOCOL_IMG, runs=1, csv=out_csv,
         seconds=seconds, pipeline_calls=calls, nms_launches=launches)
    check([r["batch"] for r in rows] == list(B.PROTOCOL_LADDER), "protocol rows missing")
    check(all(math.isfinite(r[k]) for r in rows for k in B.PROTOCOL_FIELDS),
          "a protocol row is not finite")
    check(launches == calls, f"the protocol launched the NMS kernel {launches} times in "
                             f"{calls} pipeline calls")
    protocol_f32_batch(B, PL, N, E, D)
    return launches


def phase_protocol_trained(B):
    """The bench's ``--protocol`` CLI with a trained artifact in place: a
    seeded tiny ``YoloHead`` (4 classes, 64², backbone (1, 1, 1, 1, 1))
    saved in ``make_artifacts``' own format into a temporary artifacts
    directory. The trained branch must run: ``"weights": "trained"``, the
    meta's image size, at most 20 detections an image."""
    import tempfile

    from object_detectors_tpu_torch.analysis import make_artifacts as MA
    from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_

    meta = {"model": "yolo_tiny", "num_classes": 4, "img_size": 64,
            "backbone_layers": [1, 1, 1, 1, 1]}
    saved = MA.ARTIFACTS
    with tempfile.TemporaryDirectory() as tmp:
        MA.ARTIFACTS = tmp
        try:
            MA._save(os.path.join(tmp, "synthetic_yolo.pt"), init_yolo_(
                YoloHead(4, backbone_layers=(1, 1, 1, 1, 1)), seed=3).state_dict(), meta)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                B.main(["--protocol", "--batch-sizes", "8", "64"])
        finally:
            MA.ARTIFACTS = saved
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    rows = line["rows"]
    emit(phase="protocol_trained", weights=line["weights"], card=line["card"],
         rows=rows, value=line["value"])
    check(line["weights"] == "trained", f"bench --protocol scored {line['weights']} weights "
                                        f"with an artifact in place")
    check(all(r["img_size"] == meta["img_size"] for r in rows),
          f"the trained protocol ran at {[r['img_size'] for r in rows]}")
    check(all(r["detections"] <= 20 * PROTOCOL_IMAGES for r in rows),
          f"the trained protocol kept more than 20 detections an image: {rows}")
    check(all(math.isfinite(r[k]) for r in rows for k in B.PROTOCOL_FIELDS),
          "a trained protocol row is not finite")
    return line


def planted_set():
    """A renderable synthetic set at COCO-like sizes: 32 images of 480² to
    640², up to 6 boxes of 80 classes each (the boxes lie inside 480²)."""
    from object_detectors_tpu_torch.data import synthetic

    gt = synthetic.make_coco_dicts(np.random.RandomState(7), 32, 480, NUM_CLASSES, 6)
    for i, im in enumerate(gt["images"]):
        im["height"], im["width"] = PLANTED_SIZES[i % len(PLANTED_SIZES)]
    return gt, lambda info: synthetic.render_image(gt, info["id"])


def planted_candidates(batch, rng, inp: int, n: int = 256):
    """Each valid GT of a batch as a candidate (xyxy at ``inp``) at score
    0.9, with three seeded jittered duplicates at lower scores, padded to
    ``n`` candidates: (boxes, scores, labels, valid) on the CPU."""
    b = len(batch["gt_valid"])
    boxes = np.zeros((b, n, 4), np.float32)
    scores = np.zeros((b, n), np.float32)
    labels = np.zeros((b, n), np.int32)
    valid = np.zeros((b, n), bool)
    for i in range(b):
        k = 0
        for cxcywh, lab in zip(batch["gt_boxes"][i][batch["gt_valid"][i]],
                               batch["gt_labels"][i][batch["gt_valid"][i]]):
            cx, cy, w, h = cxcywh * inp
            box = np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], np.float32)
            for j in range(4):
                jitter = 0 if j == 0 else rng.uniform(-0.04, 0.04, 4) * [w, h, w, h]
                boxes[i, k] = box + jitter
                scores[i, k] = 0.9 if j == 0 else rng.uniform(0.2, 0.8)
                labels[i, k], valid[i, k] = lab, True
                k += 1
    return [torch.from_numpy(a) for a in (boxes, scores, labels, valid)]


def gt_pairs_above(gt, thr=0.6) -> int:
    """GT pairs in one image whose IoU exceeds ``thr`` (class-agnostic NMS
    keeps one box of such a pair)."""
    by_image = {}
    for a in gt["annotations"]:
        x, y, w, h = a["bbox"]
        by_image.setdefault(a["image_id"], []).append([x, y, x + w, y + h])
    pairs = 0
    for boxes in by_image.values():
        b = torch.tensor(boxes, dtype=torch.float64)
        lt = torch.maximum(b[:, None, :2], b[None, :, :2])
        rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
        inter = (rb - lt).clamp(min=0).prod(-1)
        area = (b[:, 2:] - b[:, :2]).prod(-1)
        iou = inter / (area[:, None] + area[None, :] - inter)
        pairs += int((iou > thr).triu(1).sum())
    return pairs


def phase_eval_planted(N, KN, P):
    """The card version of the JAX round-trip test
    (tests/test_data_eval_pipeline.py:217): ``planted_set`` through
    ``yolo_batches_uint8`` (640² canvas, batches of 16), the canvas resized
    to 416 on the card against the CPU port (f32 within 1e-5; bf16 within
    one bf16 ulp of max(|cpu|, 1)), each GT planted as a candidate with
    three jittered duplicates, ``nms_majority`` on the card (the NMS kernel,
    launches counted: one a batch) identical to the CPU, the evaluator's
    stats on the card's output equal to the CPU's. Returns the launches."""
    from object_detectors_tpu_torch.data import coco as D
    from object_detectors_tpu_torch.eval import evaluator as E

    gt, loader = planted_set()
    ds = D.CocoDetectionDataset(gt, label_mode="lvis0", image_loader=loader)
    evs = {dev: E.DetectionEvaluator(gt, label_map=lambda c: c + 1) for dev in ("cuda", "cpu")}
    rng = np.random.RandomState(8)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    KN.launches = 0
    batches = 0
    for batch in D.yolo_batches_uint8(ds, 16, PROTOCOL_IMG, canvas_size=CANVAS, max_boxes=8):
        canvas, sizes = torch.from_numpy(batch["images"]), torch.from_numpy(batch["sizes"])
        for dtype in worst:
            gpu = P.resize_normalize_from_canvas(canvas.cuda(), sizes.cuda(), PROTOCOL_IMG,
                                                 dtype).cpu().float()
            cpu = P.resize_normalize_from_canvas(canvas, sizes, PROTOCOL_IMG, dtype).float()
            if dtype == torch.float32:
                torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-5)
            else:
                check(((gpu - cpu).abs() <= 2.0 ** -7 * cpu.abs().clamp(min=1.0)).all(),
                      "the bf16 canvas resize differs from the CPU by more than one ulp")
            worst[dtype] = max(worst[dtype], (gpu - cpu).abs().max().item())
        cand = planted_candidates(batch, rng, PROTOCOL_IMG)
        before = KN.launches
        on_gpu = N.nms_majority(*(t.cuda() for t in cand[:3]), NUM_CLASSES, 0.6, 100,
                                valid=cand[3].cuda())
        check(KN.launches - before == 1, "nms_majority launched the NMS kernel "
                                         f"{KN.launches - before} times")
        on_cpu = N.nms_majority(*cand[:3], NUM_CLASSES, 0.6, 100, valid=cand[3])
        check(all(torch.equal(g.cpu(), c) for g, c in zip(on_gpu, on_cpu)),
              "nms_majority on the planted candidates differs between GPU and CPU")
        n = int((batch["image_ids"] >= 0).sum())
        for dev, out in (("cuda", on_gpu), ("cpu", on_cpu)):
            evs[dev].update(batch["image_ids"][:n], *(o[:n] for o in out),
                            batch["scale_factors"][:n])
        batches += 1
    launches = KN.launches
    stats = {dev: ev.summarize() for dev, ev in evs.items()}
    pairs = gt_pairs_above(gt)
    emit(phase="eval_planted", images=len(ds), batches=batches, canvas=CANVAS,
         img=PROTOCOL_IMG, resize_max_abs_err={str(k): v for k, v in worst.items()},
         nms_launches=launches, detections=len(evs["cuda"].results),
         annotations=len(gt["annotations"]), map=float(stats["cuda"][0]),
         map50=float(stats["cuda"][1]), gt_pairs_above_iou_0_6=pairs,
         stats_identical=bool(np.array_equal(stats["cuda"], stats["cpu"])))
    check(launches == batches, f"eval_planted launched the NMS kernel {launches} times in "
                               f"{batches} batches")
    check(float(np.abs(stats["cuda"] - stats["cpu"]).max()) <= 1e-6,
          "the planted evaluation differs between GPU and CPU")
    check(stats["cuda"][0] > 0.5, f"planted mAP {stats['cuda'][0]} is too low for planted GT")
    if pairs == 0:
        check(stats["cuda"][0] >= 1 - 1e-6, "planted GT without overlapping pairs scored "
                                            f"mAP {stats['cuda'][0]}")
    return launches


def ingest_time(fn, canvas, out_shape, taps: int):
    """A canvas resize timed with CUDA events (f32 output, TF32 off), with
    the bytes it must move (the uint8 canvas read, the f32 images written)
    and the operations of a separable ``taps``-tap filter (the least the
    function needs), beside the dense products it runs."""
    b, hc, wc, c = canvas.shape
    oh, ow = out_shape
    ms = cuda_ms(fn, 20)
    moved = canvas.numel() + b * oh * ow * c * 4
    ops = 2 * taps * b * c * (oh * wc + oh * ow)
    dense = 2 * b * c * (oh * hc * wc + oh * ow * wc)
    bound, by = time_bound(moved, ops)
    return dict(ms=ms, bytes=moved, gb_per_s=moved / ms / 1e6, bound_ms=bound, bound_by=by,
                dense_flops=dense, dense_tflop_per_s=dense / ms / 1e9)


def phase_ingest(P):
    """The two canvas resizes timed at their paths' shapes (stage timings,
    not kernels: plain PyTorch products against the sampling matrices):
    the YOLO bicubic resize of a uint8 [16, 640, 640, 3] canvas to 416 and
    the R-CNN bilinear resize of [2, 640, 640, 3] to 800² (the canvas
    detection_main sizes to the largest image; a COCO image's longer side is
    640). Then each family's tiny ingest train step (``tiny_steps``) on the
    GPU against the CPU within the tolerances of ``yolo_train`` and
    ``frcnn_train``, the Faster R-CNN one launching each of its three kernels
    once."""
    from object_detectors_tpu_torch.train import tiny_steps as TS

    rng = np.random.RandomState(9)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yolo = torch.from_numpy(rng.randint(0, 256, (16, CANVAS, CANVAS, 3), dtype=np.uint8))
        ysizes = torch.from_numpy(np.stack([rng.randint(320, CANVAS + 1, 16),
                                            rng.randint(320, CANVAS + 1, 16)], 1))
        yolo, ysizes = yolo.cuda(), ysizes.cuda()
        t = ingest_time(lambda: P.resize_normalize_from_canvas(yolo, ysizes, PROTOCOL_IMG,
                                                               torch.float32),
                        yolo, (PROTOCOL_IMG, PROTOCOL_IMG), 4)
        emit(phase="ingest", stage="resize_normalize_from_canvas", canvas=list(yolo.shape),
             out=[16, PROTOCOL_IMG, PROTOCOL_IMG, 3], out_dtype="float32", **t)
        rcnn = torch.from_numpy(rng.randint(0, 256, (2, CANVAS, CANVAS, 3),
                                            dtype=np.uint8)).cuda()
        rsizes = torch.tensor([[480, 640], [640, 427]]).cuda()
        t = ingest_time(lambda: P.rcnn_resize_normalize_from_canvas(rcnn, rsizes, (800, 800),
                                                                    800, 1333),
                        rcnn, (800, 800), 2)
        emit(phase="ingest", stage="rcnn_resize_normalize_from_canvas", canvas=list(rcnn.shape),
             out=[2, 800, 800, 3], out_dtype="float32", **t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow

    models, before, metrics = TS.yolo_step_on_both(torch.float32, ingest=True)
    for key in ("loss", "sub_losses", "stats"):
        g, c = metrics["cuda"][key].cpu(), metrics["cpu"][key]
        emit(phase="ingest", what=f"tiny Darknet ingest step (128² canvas to 96), GPU vs CPU "
                                  f"{key}", max_abs_err=(g - c).abs().max().item(),
             max_abs_ref=c.abs().max().item())
        torch.testing.assert_close(g, c, rtol=TS.TRAIN_LOSS_RTOL, atol=1e-6)
    check_update_gap(TS, "ingest", "tiny Darknet ingest step", models, before,
                     norm_share=TS.YOLO_F32_UPDATE_NORM)

    models, before, tiny, launches = TS.frcnn_step_on_both(ingest=True)
    for k, v in tiny["cpu"].items():
        emit(phase="ingest", what=f"tiny Faster R-CNN ingest step (96² canvas to 64), GPU vs "
                                  f"CPU {k}", gpu=tiny["cuda"][k].item(), cpu=v.item())
        torch.testing.assert_close(tiny["cuda"][k].cpu(), v, rtol=TS.FRCNN_LOSS_RTOL, atol=1e-6)
    emit(phase="ingest", what="tiny Faster R-CNN ingest step launches (RoIAlign forward, "
                              "backward, NMS)", launches=launches)
    check(launches == {"cpu": (0, 0, 0), "cuda": (1, 1, 1)},
          f"the tiny Faster R-CNN ingest step's launches: {launches}")
    check_update_gap(TS, "ingest", "tiny Faster R-CNN ingest step", models, before,
                     worst_share=TS.FRCNN_UPDATE_SHARE)


# -- detection_main's architectures: Mask and Keypoint R-CNN, SSD300,
# RetinaNet training, all through ``ModelAdapter`` at the CLI's defaults

DM_IMG, DM_BATCH, SSD_IMG = 800, 2, 300   # detection_main --image-size / --batch-size
CLS_SCALE = 40.0   # class scores spread apart, as the CPU tests do (see dm_adapter)
KP_ATOL = 1e-3  # GPU vs CPU keypoints in pixels, the CPU tests' tolerance against JAX


def dm_adapter(DM, name, size, device="cuda"):
    """``ModelAdapter(name)`` at full width (91 classes; Keypoint R-CNN 2),
    seeded weights, f32. The 91-way class scores are scaled by CLS_SCALE:
    at the init's scale a 91-way softmax leaves every score near 1/91, below
    the R-CNN threshold of 0.05 (no detection, the mask branch on zero
    boxes), and near-tied everywhere. Keypoint R-CNN's 2-way scores stay
    near 1/2 at the init's scale (scaled, the person score of every
    proposal falls on one side of 0.05 together)."""
    ncls = 2 if name.startswith("keypoint") else 91
    ad = DM.ModelAdapter(name, ncls, size, device=device, seed=0)
    with torch.no_grad():
        if name in DM.TWO_STAGE and ncls > 2:
            ad.model.box_predictor.cls_score.weight.mul_(CLS_SCALE)
        elif name.startswith("ssd"):
            for i in range(6):
                getattr(ad.model.head, f"cls{i}").weight.mul_(CLS_SCALE)
    return ad


def dm_batches(name, size=DM_IMG, count=3, device="cuda"):
    """frcnn_train800's seeded batches (normalized images, 20 GT slots an
    image, 70 % valid) as ``ModelAdapter`` batches; Mask R-CNN's masks are
    the GT boxes' interiors [B, 20, H, W], Keypoint R-CNN's 17 keypoints a
    box lie in it (80 % visible) and its labels are 1 (2 classes)."""
    from object_detectors_tpu_torch.analysis.train_stages import frcnn_train_batch

    out = []
    for seed in range(count):
        images, boxes, labels, valid = frcnn_train_batch(seed, DM_BATCH, size, device=device)
        batch = dict(images=images, gt_boxes=boxes, gt_labels=labels, gt_valid=valid)
        if name.startswith("mask"):
            r = torch.arange(size, device=device, dtype=torch.float32)
            b = boxes[..., None]
            batch["gt_masks"] = (((r >= b[:, :, 1]) & (r < b[:, :, 3]))[..., :, None]
                                 & ((r >= b[:, :, 0]) & (r < b[:, :, 2]))[..., None, :]).float()
        if name.startswith("keypoint"):
            g = torch.Generator(device=device).manual_seed(10 + seed)
            lo, hi = boxes[:, :, None, :2], boxes[:, :, None, 2:]
            pts = lo + torch.rand(*boxes.shape[:2], 17, 2, generator=g, device=device) * (hi - lo)
            vis = (torch.rand(*boxes.shape[:2], 17, 1, generator=g, device=device) < 0.8) * 2.0
            batch["gt_keypoints"] = torch.cat([pts, vis], -1)
            batch["gt_labels"] = torch.ones_like(labels)
        out.append(batch)
    return out


def roi_forward_time(KR, maps, boxes, size, out_size):
    """The RoIAlign forward kernel alone at one input: its time and its plain
    version's (CUDA events), its bound (the level maps, boxes and levels
    read once, the output written once; 4 multiply-adds a sample, 4 samples
    and a divide a bin and channel) and its staged and direct RoIs."""
    route = torch.empty(boxes.shape[:2], dtype=torch.uint8, device="cuda")
    pooled = KR.multiscale_roi_align_cuda(maps, boxes, (size, size), out_size, route=route)
    ms = cuda_ms(lambda: KR.multiscale_roi_align_cuda(maps, boxes, (size, size), out_size), 20)
    plain_ms = cuda_ms(lambda: KR.multiscale_roi_align_reference(maps, boxes, (size, size),
                                                                 out_size), 2)
    moved = (pooled.numel() * pooled.element_size()
             + sum(f.numel() * f.element_size() for f in maps) + boxes.numel() * 4
             + boxes.numel())
    ops = pooled.numel() * (8 * 2 * 2 + 1)
    bound, bound_by = time_bound(moved, ops)
    staged = (route % 2).bool()
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, bytes=moved,
                operations=ops, out_shape=list(pooled.shape), staged_rois=int(staged.sum()),
                direct_rois=int((~staged).sum()))


def branch_consistency(DM, phase, name, gpu, image):
    """One image through the port on the GPU and on the CPU (same weights,
    f32, TF32 off): the FPN maps and RPN outputs within FEAT_*; then the
    rest of the path (proposal filter, box head, postprocess and the mask
    or keypoint branch) on both devices from the GPU's maps and RPN
    outputs: labels, valid flags and order identical, boxes within 1e-3,
    scores within SCORE_ATOL, masks within RAW_*; keypoints within KP_ATOL
    pixels, their scores within RAW_*."""
    from object_detectors_tpu_torch.models.mask_rcnn import maskrcnn_inference
    from object_detectors_tpu_torch.models.keypoint_rcnn import heatmaps_to_keypoints_exact
    from object_detectors_tpu_torch.models.common import tf32_off

    cpu = DM.ModelAdapter(name, gpu.model.cfg.num_classes, DM_IMG, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    noop = lambda stage: None  # noqa: E731
    outs, trunks = {}, {}
    with tf32_off(), torch.no_grad():
        for dev, ad in (("cuda", gpu), ("cpu", cpu)):
            trunks[dev] = ad.model.eval()._trunk(image.to(dev), noop)
        feats_g, obj_g, deltas_g, sizes, size = trunks["cuda"]
        feats_c, obj_c, deltas_c, _, _ = trunks["cpu"]
        pairs = [(f"P{i + 2}", g, c) for i, (g, c) in enumerate(zip(feats_g, feats_c))]
        for what, g, c in pairs + [("objectness", obj_g, obj_c), ("deltas", deltas_g, deltas_c)]:
            g = g.cpu()
            emit(phase=phase, what=f"GPU vs CPU {what}", shape=list(c.shape),
                 max_abs_err=(g - c).abs().max().item(), max_abs_ref=c.abs().max().item())
            torch.testing.assert_close(g, c, rtol=FEAT_RTOL, atol=FEAT_ATOL)
        for dev, ad in (("cuda", gpu), ("cpu", cpu)):
            feats = [f.to(dev) for f in feats_g]
            m = ad.model
            det = m._detect(feats, obj_g.to(dev), deltas_g.to(dev), sizes, size, None, noop)
            if name.startswith("mask"):
                extra = (maskrcnn_inference(m.mask_logits(feats, det[0], size), det[2]),)
            else:
                extra = heatmaps_to_keypoints_exact(m.keypoint_logits(feats, det[0], size),
                                                    det[0])
            outs[dev] = [t.cpu() for t in (*det, *extra)]
    g, c = outs["cuda"], outs["cpu"]
    same = torch.equal(g[2], c[2]) and torch.equal(g[3], c[3])
    fields = dict(valid=int(c[3].sum()), labels_and_valid_identical=same,
                  boxes_max_abs_diff=(g[0] - c[0]).abs().max().item(),
                  scores_max_abs_diff=(g[1] - c[1]).abs().max().item())
    if name.startswith("mask"):
        fields["masks_max_abs_diff"] = (g[4] - c[4]).abs().max().item()
    else:
        kp = (g[4] - c[4]).abs()
        fields.update(keypoints_max_abs_diff=kp.max().item(),
                      kp_scores_max_abs_diff=(g[5] - c[5]).abs().max().item())
    emit(phase=phase, what="GPU vs CPU: the path from the GPU's maps and RPN outputs",
         **fields)
    check(same, f"{phase}: labels or order differ between the GPU and the CPU")
    check(int(c[3].sum()) > 0, f"{phase}: no detection on the CPU")
    torch.testing.assert_close(g[0], c[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(g[1], c[1], rtol=0, atol=SCORE_ATOL)
    if name.startswith("mask"):
        torch.testing.assert_close(g[4], c[4], rtol=RAW_RTOL, atol=RAW_ATOL)
    else:
        torch.testing.assert_close(g[4], c[4], rtol=0, atol=KP_ATOL)
        torch.testing.assert_close(g[5], c[5], rtol=RAW_RTOL, atol=RAW_ATOL)


def phase_rcnn_branch_eval(DM, KR, KN, name, phase):
    """maskrcnn800 / kprcnn800: ``detect_with_masks`` (``detect_with_keypoints``)
    at 800², batch 2, f32 (TF32 for cuDNN): 2 warm-up calls, timed calls
    whose RoIAlign and NMS launches are counted (two RoIAlign a call: the 7x7
    box pooler and the 14x14 branch pooler; two NMS: the RPN filter and the
    postprocess); the 14x14 branch pooler held against its plain version at
    its own maps and detections and timed there; for Keypoint R-CNN the
    exact decode's time at its own logits; GPU vs CPU on one image."""
    ad = dm_adapter(DM, name, DM_IMG)
    images = [b["images"] for b in dm_batches(name, count=3)]
    fn = ad.detect_with_masks if name.startswith("mask") else ad.detect_with_keypoints
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    dt, out, launches = timed_calls(fn, images, {"roi_align": KR, "nms": KN}, iters)
    check(all(bool(torch.isfinite(t.float()).all()) for t in out), f"{phase} output not finite")
    check(tuple(out[0].shape) == (DM_BATCH, 100, 4), f"{phase} boxes {tuple(out[0].shape)}")
    for key, per in (("roi_align", 2), ("nms", 2)):
        check(launches[key] == per * iters, f"{phase} launched the {key} kernel "
                                            f"{launches[key]} times in {iters} calls")
    emit(phase=phase, batch=DM_BATCH, img=DM_IMG, num_classes=ad.model.cfg.num_classes,
         ms_per_batch=dt * 1e3, imgs_per_s=DM_BATCH / dt, tf32=tf32_state(),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         valid_detections=int(out[3].sum()), launches=launches,
         launches_per_call={k: v / iters for k, v in launches.items()},
         extra_shape=list(out[4].shape))

    with watched(KR, "multiscale_roi_align_cuda") as calls:
        fn(images[0])
    (maps, boxes, size, out_size, ratio), _ = calls[1]
    check(out_size == (14, 14) and ratio == 2, f"{phase} branch pooler at {out_size}")
    err, staged = check_roi_align(KR, f"{phase} branch pooler, the path's own maps and "
                                  f"detections", list(maps), boxes, size[0], out_size)
    t = roi_forward_time(KR, list(maps), boxes, size[0], out_size)
    emit(phase="kernel_time", name="roi_align", case=f"{phase} 14x14 branch pooler",
         valid_boxes=int((boxes[..., 2] > boxes[..., 0]).sum()), library_ms=None, **t)
    fields = dict(launches=launches, max_abs_err=err, ms_per_batch=dt * 1e3,
                  roi_align_14x14={k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "staged_rois", "direct_rois")})
    if name.startswith("keypoint"):
        from object_detectors_tpu_torch.models.keypoint_rcnn import heatmaps_to_keypoints_exact

        with torch.no_grad():
            feats = ad.model._trunk(images[0], lambda stage: None)
            logits = ad.model.keypoint_logits(feats[0], boxes, (DM_IMG, DM_IMG))
        decode_ms = cuda_ms(lambda: heatmaps_to_keypoints_exact(logits, boxes), 3)
        emit(phase=phase, what="heatmaps_to_keypoints_exact at the path's own logits",
             logits=list(logits.shape), ms=decode_ms)
        fields["heatmaps_to_keypoints_exact_ms"] = decode_ms
    branch_consistency(DM, phase, name, ad, images[0][:1])
    return fields


def dm_train_state(DM, trainer, name, size):
    """The adapter and its train state with detection_main's optimizer (as
    frcnn_train_setup: SGD 0.0025, momentum 0.9, weight decay 1e-4, the
    multistep decay at epochs 16 and 22, warmup over 1000 steps from
    1/1000)."""
    from object_detectors_tpu_torch.train import optim

    ad = dm_adapter(DM, name, size)
    tx = optim.make_optimizer(optim.OptimizerConfig("sgd", 0.0025, 1e-4, 0.9),
                              optim.SchedulerConfig("multistep", milestones=(16, 22),
                                                    warmup_steps=1000,
                                                    warmup_factor=1.0 / 1000), 1000)
    return ad, trainer.create_detection_train_state(ad, tx)


def phase_dm_train(DM, KR, KB, KN, name, phase, size=DM_IMG, per_step=(0, 0, 0)):
    """``detection_train_step`` of ``name`` at ``size``², batch 2, f32:
    2 warm-up steps, timed steps whose RoIAlign forward, backward and NMS
    launches are counted (``per_step`` each), finite losses, peak memory;
    for Mask and Keypoint R-CNN one more step whose 14x14 RoIAlign backward
    is held against its plain version at its own cotangent and RoIs and
    timed there; the tiny step of ``tiny_steps.adapter_step_on_both`` on
    the GPU against the CPU."""
    from object_detectors_tpu_torch.train import tiny_steps as TS
    from object_detectors_tpu_torch.train import trainer

    ad, state = dm_train_state(DM, trainer, name, size)
    batches = dm_batches(name, size)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i in range(2):
        _, total, _ = trainer.detection_train_step(state, ad, batches[i % 3], generator=gen)
    float(total)
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    KR.launches = KB.launches = KN.launches = 0
    t0 = time.perf_counter()
    for i in range(iters):
        _, total, losses = trainer.detection_train_step(state, ad, batches[i % 3], generator=gen)
    last = float(total)
    dt = (time.perf_counter() - t0) / iters
    launches = {"roi_align": KR.launches, "roi_align_bwd": KB.launches, "nms": KN.launches}
    losses = {k: v.item() for k, v in losses.items()}
    emit(phase=phase, batch=DM_BATCH, img=size, ms_per_step=dt * 1e3,
         imgs_per_s=DM_BATCH / dt, loss=last, losses=losses, tf32=tf32_state(),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
         launches_per_step={k: v / iters for k, v in launches.items()})
    check(math.isfinite(last) and all(math.isfinite(v) for v in losses.values()),
          f"{phase} losses are not finite")
    for key, per in zip(("roi_align", "roi_align_bwd", "nms"), per_step):
        check(launches[key] == per * iters, f"{phase} launched the {key} kernel "
                                            f"{launches[key]} times in {iters} steps")
    fields = dict(ms_per_step=dt * 1e3, launches=launches, max_abs_err=0.0)
    if name in DM.TWO_STAGE:
        with watched(KB, "multiscale_roi_align_backward_cuda") as calls:
            trainer.detection_train_step(state, ad, batches[0], generator=gen)
        check(sorted(c[0][4] for c in calls) == [(7, 7), (14, 14)],
              f"{phase}'s RoIAlign backward at {[c[0][4] for c in calls]}")
        cot, boxes, shapes, bsize, bout, _, _ = next(a for a, _ in calls if a[4] == (14, 14))
        check(cot.dtype == torch.float32 and tuple(cot.shape) == (DM_BATCH, 512, 14, 14, 256),
              f"{phase} 14x14 cotangent {tuple(cot.shape)} {cot.dtype}")
        fields["max_abs_err"] = check_roi_backward(
            KR, KB, f"{phase} 14x14 branch, a step's own cotangent and RoIs", shapes, boxes,
            cot, bsize[0])
        t = roi_backward_time(KR, KB, shapes, boxes, cot, bsize[0])
        t["plain_ms"] = cuda_ms(lambda: KB.multiscale_roi_align_backward_reference(
            cot, boxes, shapes, bsize, (14, 14), dtype=cot.dtype), 2)
        emit(phase="kernel_time", name="roi_align_backward", dtype=str(cot.dtype),
             case=f"{phase} 14x14 branch, a step's own cotangent and RoIs",
             cotangent_shape=list(cot.shape), library_ms=None, **t)
        fields["roi_align_bwd_14x14"] = {k: t[k] for k in (
            "ms", "plain_ms", "kernel_only_ms", "zeroing_ms", "bound_ms", "bound_by",
            "staged_rois", "direct_rois")}

    models, before, tiny, tiny_launches = TS.adapter_step_on_both(name)
    for k, v in tiny["cpu"].items():
        emit(phase=phase, what=f"tiny {name}, GPU vs CPU {k}", gpu=tiny["cuda"][k].item(),
             cpu=v.item())
        torch.testing.assert_close(tiny["cuda"][k].cpu(), v, rtol=TS.FRCNN_LOSS_RTOL, atol=1e-6)
    want = (2, 2, 1) if name in DM.TWO_STAGE else (0, 0, 0)
    check(tiny_launches == {"cpu": (0, 0, 0), "cuda": want},
          f"the tiny {name} step's RoIAlign forward, backward and NMS launches: "
          f"{tiny_launches}")
    check_update_gap(TS, phase, f"tiny {name}", models, before,
                     worst_share=TS.FRCNN_UPDATE_SHARE)
    return fields


def phase_ssd300(DM, KN):
    """ssd300: ``detect`` at 300², batch 2, f32: timed calls whose NMS
    launches are counted (one a call, the postprocess's class-aware NMS
    over the 1200-candidate cap, 200 kept); the NMS kernel held against its
    plain version at that call's inputs (identical) and timed there; on one
    image the raw outputs GPU vs CPU within FEAT_* and the postprocess on
    the GPU's outputs on both devices: labels, valid flags and order
    identical, boxes within 1e-3, scores within SCORE_ATOL."""
    from object_detectors_tpu_torch.models import ssd as SSD
    from object_detectors_tpu_torch.models.common import tf32_off

    ad = dm_adapter(DM, "ssd300_vgg16", SSD_IMG)
    images = [b["images"] for b in dm_batches("ssd300_vgg16", SSD_IMG)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    dt, out, launches = timed_calls(ad.detect, images, {"nms": KN}, iters)
    check(launches["nms"] == iters, f"ssd300 launched the NMS kernel {launches['nms']} times "
                                    f"in {iters} calls")
    check(tuple(out[0].shape) == (DM_BATCH, 200, 4) and bool(torch.isfinite(out[0]).all()),
          "ssd300 output")
    emit(phase="ssd300", batch=DM_BATCH, img=SSD_IMG, num_classes=91, ms_per_batch=dt * 1e3,
         imgs_per_s=DM_BATCH / dt, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         valid_detections=int(out[3].sum()), launches=launches)
    with watched(KN, "greedy_nms_cuda") as calls:
        ad.detect(images[0])
    (b, sc, thr, k, valid), _ = calls[0]
    check(tuple(sc.shape) == (DM_BATCH, 1200) and k == 200, f"ssd300 NMS at {tuple(sc.shape)}")
    check_nms(KN, "ssd300 postprocess, the path's own candidates", b, sc, thr, k, valid)
    t = nms_kernel_time(KN, b, sc, thr, k, valid)
    emit(phase="kernel_time", name="nms", case="ssd300 postprocess", groups=sc.shape[0],
         n=sc.shape[1], max_output=k, iou_threshold=thr, library_ms=None, **t)

    cpu = DM.ModelAdapter("ssd300_vgg16", 91, SSD_IMG, device="cpu")
    cpu.model.load_state_dict(ad.model.state_dict())
    with tf32_off(), torch.no_grad():
        raw = {dev: a.model.eval()(images[0][:1].to(dev)) for dev, a in (("cuda", ad),
                                                                           ("cpu", cpu))}
        for i, what in enumerate(("cls_logits", "bbox_reg")):
            g, c = raw["cuda"][i].cpu(), raw["cpu"][i]
            emit(phase="ssd300", what=f"GPU vs CPU {what}", shape=list(c.shape),
                 max_abs_err=(g - c).abs().max().item(), max_abs_ref=c.abs().max().item())
            torch.testing.assert_close(g, c, rtol=FEAT_RTOL, atol=FEAT_ATOL)
        cls, reg, sizes = raw["cuda"]
        post = {}
        for dev, a in (("cuda", ad), ("cpu", cpu)):
            post[dev] = [x.cpu() for x in SSD.ssd_postprocess(
                cls.to(dev), reg.to(dev), a._ssd_anchors(sizes), (SSD_IMG, SSD_IMG), a.cfg)]
    g, c = post["cuda"], post["cpu"]
    same = torch.equal(g[2], c[2]) and torch.equal(g[3], c[3])
    emit(phase="ssd300", what="GPU vs CPU postprocess on the GPU's outputs", valid=int(c[3].sum()),
         labels_and_valid_identical=same, boxes_max_abs_diff=(g[0] - c[0]).abs().max().item(),
         scores_max_abs_diff=(g[1] - c[1]).abs().max().item())
    check(same and int(c[3].sum()) > 0, "ssd300 postprocess labels or order differ between "
                                        "the GPU and the CPU, or nothing was kept")
    torch.testing.assert_close(g[0], c[0], rtol=0, atol=1e-3)
    torch.testing.assert_close(g[1], c[1], rtol=0, atol=SCORE_ATOL)
    return dict(launches=launches["nms"], ms_per_batch=dt * 1e3,
                nms={key: t[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "kept")})


@contextlib.contextmanager
def per_call(owner, name, kernels):
    """While inside, each call of ``owner.name`` is timed on the host clock
    between two synchronizations and the launches of ``kernels`` ({label:
    wrapper module}) in it are counted: yields a list with one dict a call
    (``ms``, ``launches``, ``args``: the call's (args, kwargs))."""
    calls = []
    wrapped = getattr(owner, name)

    def spy(*args, **kwargs):
        before = {k: m.launches for k, m in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wrapped(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "launches": {k: m.launches - before[k] for k, m in kernels.items()},
                      "args": (args, kwargs)})
        return out

    setattr(owner, name, spy)
    try:
        yield calls
    finally:
        setattr(owner, name, wrapped)


def steady_ms(calls) -> float:
    """The median time of the calls after the first (which autotunes)."""
    times = [c["ms"] for c in calls[1:]] or [c["ms"] for c in calls]
    return float(np.median(times))


def same_payload(a, b) -> bool:
    """Two checkpoint payloads bitwise equal (tensors by value and dtype)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            same_payload(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_payload(x, y) for x, y in zip(a, b))
    return a == b


CLI_OUT = "chiprun_out"


def drop_weights(directory: str) -> None:
    """Delete the checkpoints' weight files under ``directory`` once a phase
    has read them (hundreds of MB at full width; the sidecars, progress CSV
    and detections stay)."""
    for root, _, files in os.walk(directory):
        for name in files:
            if name.endswith(".pt"):
                os.remove(os.path.join(root, name))


def phase_yolo_cli(N, KN):
    """yolo_cli416: the YOLO CLI (``main.main``) in-process on the card: the
    full Darknet-53 at 416² (bf16), one epoch on 32 synthetic images at
    batch 8, ``evaluate --checkpoint best --dump-json``, ``resume=true
    epochs=2`` (module docstring, phase 32). Returns the NMS launches of the
    three runs and the timings."""
    import shutil

    from object_detectors_tpu_torch import main as M
    from object_detectors_tpu_torch.train import checkpoint as ckpt_lib

    out = f"{CLI_OUT}/yolo_cli416"
    shutil.rmtree(out, ignore_errors=True)
    ov = ["dataset=synthetic", "backbone=darknet53", "dataset.inp_dim=416",
          "dataset.num_images=32", "dataset.tr_batch_size=8", "dataset.ts_batch_size=8",
          "epochs=1", "metric=mAP", f"output_dir={out}"]
    batches = 32 // 8
    KN.launches = 0
    with (per_call(M.trainer, "yolo_train_step_ingest", {"nms": KN}) as steps,
          per_call(M, "decode_and_nms", {"nms": KN}) as evals):
        _, best = M.main(["train", *ov])
        ckpts = f"{out}/checkpoints"
        for tag in ("last", "best"):
            check(all(os.path.exists(f"{ckpts}/{tag}{ext}") for ext in (".pt", ".meta.json")),
                  f"yolo_cli416 wrote no {tag} checkpoint")
        saved = torch.load(f"{ckpts}/last.pt", weights_only=True)
        with watched(M, "nms_majority") as nms_calls:
            mAP = M.main(["evaluate", *ov, "--checkpoint", "best",
                          "--dump-json", f"{out}/detections.json"])
        restored = {}
        restore = ckpt_lib.CheckpointManager.restore

        def spy_restore(self, tag, state):
            got = restore(self, tag, state)
            if got is not None:
                restored["payload"] = copy.deepcopy(ckpt_lib.state_payload(got[0]))
                restored["epoch"] = got[1]
            return got
        ckpt_lib.CheckpointManager.restore = spy_restore
        try:
            M.main(["train", *ov, "resume=true", "epochs=2"])
        finally:
            ckpt_lib.CheckpointManager.restore = restore
    launches = KN.launches
    with open(f"{out}/progress/progress.csv") as f:
        rows = [line.strip().split(",") for line in f][1:]
    losses = [float(x) for r in rows for x in r[1:8]]
    check(all(math.isfinite(x) for x in losses), f"yolo_cli416 losses {losses}")
    check([r[0] for r in rows] == ["0", "1"], f"yolo_cli416 trained epochs {[r[0] for r in rows]}")
    check(restored.get("epoch") == 0 and same_payload(restored["payload"], saved),
          "yolo_cli416's resume did not restore the saved parameters and optimizer state")
    check(math.isfinite(mAP) and math.isfinite(best), f"yolo_cli416 mAP {mAP}, best {best}")
    check(len(steps) == 2 * batches and len(evals) == 3 * batches,
          f"yolo_cli416 ran {len(steps)} train steps and {len(evals)} eval batches")
    check(all(c["launches"]["nms"] == 1 for c in evals) and launches == len(evals),
          f"yolo_cli416 NMS launches: {[c['launches']['nms'] for c in evals]}, {launches}")
    # the eval batch with the most candidates above the confidence threshold;
    # its candidates also all taken as valid, so that the kept set is not empty
    (b, sc, lab), kw = max(nms_calls, key=lambda c: int(c[1]["valid"].sum()))
    check(kw["iou_threshold"] == 0.6 and kw["max_output"] == 100,
          f"yolo_cli416's NMS at {kw}")
    _, kept = same_nms(N, "yolo_cli416", "an eval batch's own candidates", b, sc, lab,
                       kw["valid"], num_classes=kw["num_classes"])
    _, kept_all = same_nms(N, "yolo_cli416", "an eval batch's own candidates, all valid", b,
                           sc, lab, None, num_classes=kw["num_classes"])
    check(kept_all > 0, "yolo_cli416: nothing kept of an eval batch's candidates")
    drop_weights(out)
    fields = dict(launches=launches, ms_per_train_step=steady_ms(steps),
                  ms_per_eval_batch=steady_ms(evals), mAP=mAP, best=best,
                  train_steps=len(steps), eval_batches=len(evals), kept=kept,
                  kept_all_valid=kept_all)
    emit(phase="yolo_cli416", batch=8, img=416, resumed_from_epoch=restored["epoch"],
         final_losses=dict(zip(("xy", "wh", "iou", "pos_conf", "neg_conf", "cls", "total"),
                               map(float, rows[-1][1:8]))), **fields)
    return fields


def phase_frcnn_cli(KR, KB, KN):
    """frcnn_cli800: ``detection_main.main`` in-process on the card: the full
    R50-FPN Faster R-CNN at 800², batch 2 (module docstring, phase 33).
    Returns the launches of its runs by kernel and the timings."""
    import shutil

    from object_detectors_tpu_torch import detection_main as DM

    out = f"{CLI_OUT}/frcnn_cli800"
    shutil.rmtree(out, ignore_errors=True)
    cli = ["--dataset", "synthetic", "--model", "fasterrcnn_resnet50_fpn", "--epochs", "1",
           "--batch-size", "2", "--image-size", "800", "--max-boxes", "8"]
    kernels = {"roi_align": KR, "roi_align_bwd": KB, "nms": KN}
    KR.launches = KB.launches = KN.launches = 0
    with (per_call(DM.trainer, "detection_train_step", kernels) as steps,
          per_call(DM.ModelAdapter, "detect", kernels) as evals):
        state = DM.main([*cli, "--output-dir", out])
        check(state is not None, "frcnn_cli800 stopped on a non-finite loss")
        mAP = DM.main([*cli, "--test-only", "--resume", "last", "--output-dir", out,
                       "--dump-json", f"{out}/detections.json"])
        n_train = len(steps)
        ingest = DM.main([*cli, "--device-ingest", "--output-dir", f"{out}_ingest"])
        check(ingest is not None, "frcnn_cli800 --device-ingest stopped on a non-finite loss")
    launches = {k: m.launches for k, m in kernels.items()}
    check(n_train == 8 and len(steps) == 16, f"frcnn_cli800 ran {n_train}, {len(steps)} steps")
    check(all(c["launches"] == {"roi_align": 1, "roi_align_bwd": 1, "nms": 1} for c in steps),
          f"frcnn_cli800 launches a step: {[c['launches'] for c in steps]}")
    first = evals[0]["launches"]
    check(all(c["launches"] == first for c in evals) and first["roi_align"] >= 1
          and first["roi_align_bwd"] == 0 and first["nms"] >= 2,
          f"frcnn_cli800 launches an eval batch: {[c['launches'] for c in evals]}")
    check(math.isfinite(mAP) and os.path.exists(f"{out}/detections.json"),
          f"frcnn_cli800 mAP {mAP}")
    for run in (out, f"{out}_ingest"):
        meta = json.load(open(f"{run}/checkpoints/last.meta.json"))
        check(meta["epoch"] == 0 and math.isfinite(meta["metrics"]["mAP"]),
              f"{run}'s last checkpoint: {meta}")
    (state, adapter, batch), kw = steps[n_train - 1]["args"]
    check_frcnn_train_kernels(
        KR, KB, KN, lambda: DM.trainer.detection_train_step(state, adapter, batch, **kw),
        case="frcnn_cli800")
    for run in (out, f"{out}_ingest"):
        drop_weights(run)
    fields = dict(launches=launches, ms_per_train_step=steady_ms(steps[:n_train]),
                  ms_per_ingest_step=steady_ms(steps[n_train:]),
                  ms_per_eval_batch=steady_ms(evals), mAP=mAP, train_steps=len(steps),
                  eval_batches=len(evals), launches_per_eval_batch=first)
    emit(phase="frcnn_cli800", batch=2, img=800, **fields)
    return fields

DDP_WORLD = 2
# the ddp phase's two runs: yolo_cli416's and frcnn_cli800's configurations
# in float32, the YOLO at 8 images a global step, Faster R-CNN at 2 a rank
DDP_YOLO = ["dataset=synthetic", "backbone=darknet53", "dataset.inp_dim=416",
            "dataset.num_images=32", "dataset.tr_batch_size=8", "dataset.ts_batch_size=8",
            "epochs=1", "metric=mAP", "precision=f32"]
# the first step at world 2 against world 1 on the same global batch: the
# losses as the Faster R-CNN ones of train/tiny_steps.py (the world-2 batch
# norms take E[x²] - E[x]² over 346 112 values a channel at 416², the
# world-1 ones a Welford sum, and cuDNN picks its algorithms by batch)
DDP_LOSS_RTOL = 1e-3
# what starts a rank (with its rank and directory), and the ranks' device:
# a rehearsal on the CPU swaps both
DDP_RANK_COMMAND = [os.path.abspath(__file__), "--ddp-rank"]
DDP_DEVICE = "cuda"
DDP_FRCNN = ["--dataset", "synthetic", "--model", "fasterrcnn_resnet50_fpn", "--epochs", "1",
             "--batch-size", str(2 * DDP_WORLD), "--image-size", "800", "--max-boxes", "8"]


def host_copy(x):
    """Tensors (in dicts, lists and tuples too) copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: host_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_copy(v) for v in x)
    return x


@contextlib.contextmanager
def first_call(owner, name, keep):
    """While inside, the first call of ``owner.name`` is followed by
    ``keep(args, kwargs, out)``."""
    wrapped = getattr(owner, name)
    seen = []

    def spy(*args, **kwargs):
        out = wrapped(*args, **kwargs)
        if not seen:
            seen.append(True)
            keep(args, kwargs, out)
        return out

    setattr(owner, name, spy)
    try:
        yield
    finally:
        setattr(owner, name, wrapped)


def ddp_worker(rank: int, directory: str) -> int:
    """One rank of the ddp phase (``chip_smoke.py --ddp-rank RANK DIR``): joins
    a gloo group through a file:// rendezvous in DIR on the one card, runs
    the YOLO CLI and then detection_main's CLI as ``plan.json`` there says,
    TF32 off, and writes ``rank<RANK>.pt``: each run's launches of the three
    kernels of its path a train step and an eval batch (counted from 0 just
    before the run), ms a step, the checkpoints it wrote, its first step's
    inputs and loss share, rank 0 also that step's gradients (averaged by
    DDP), and a fingerprint of the parameters at the end."""
    with open(os.path.join(directory, "plan.json")) as f:
        plan = json.load(f)
    if plan["device"] == "cuda":
        torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(directory, 'rendezvous')}", rank=rank,
        world_size=DDP_WORLD)
    from object_detectors_tpu_torch import detection_main as DM
    from object_detectors_tpu_torch import main as M
    from object_detectors_tpu_torch.kernels import nms as KN
    from object_detectors_tpu_torch.kernels import roi_align as KR
    from object_detectors_tpu_torch.kernels import roi_align_bwd as KB
    from object_detectors_tpu_torch.models.common import tf32_off
    from object_detectors_tpu_torch.train import checkpoint as ckpt_lib

    kernels = {"roi_align": KR, "roi_align_bwd": KB, "nms": KN}
    writes = []
    save_raw = ckpt_lib.CheckpointManager.save_raw

    def spy_save(self, tag, payload, epoch, metrics):
        writes.append(os.path.join(os.path.basename(os.path.dirname(self.directory)), tag))
        return save_raw(self, tag, payload, epoch, metrics)

    def fingerprint(model):
        return {k: (float(p.detach().double().sum()), float(p.detach().double().abs().sum()))
                for k, p in ckpt_lib.unwrapped(model).named_parameters()}

    def keeper(run, out, batch_of, loss_of):
        def keep(args, kwargs, result):
            state = args[0]
            out[run] = {"batch": host_copy(batch_of(args, kwargs)),
                        "loss_share": host_copy(loss_of(result))}
            if rank == 0:
                out[run]["grads"] = {
                    k: p.grad.detach().cpu().clone()
                    for k, p in ckpt_lib.unwrapped(state.model).named_parameters()
                    if p.grad is not None}
        return keep

    first = {}
    result = {"rank": rank, "writes": writes}
    ckpt_lib.CheckpointManager.save_raw = spy_save
    try:
        with tf32_off():
            for m in kernels.values():
                m.launches = 0
            with (per_call(M.trainer, "yolo_train_step_ingest", kernels) as steps,
                  per_call(M, "decode_and_nms", kernels) as evals,
                  first_call(M.trainer, "yolo_train_step_ingest", keeper(
                      "yolo", first, lambda a, kw: (a[1:], kw),
                      lambda r: (r[1]["loss"], r[1]["sub_losses"], r[1]["stats"])))):
                state, best = M.main(["train", *plan["yolo"]])
            result["yolo"] = {
                "launches": {k: m.launches for k, m in kernels.items()},
                "per_step": [c["launches"] for c in steps],
                "per_eval_batch": [c["launches"] for c in evals],
                "ms_per_train_step": steady_ms(steps), "ms_per_eval_batch": steady_ms(evals),
                "best": best, "fingerprint": fingerprint(state.model)}
            for m in kernels.values():
                m.launches = 0
            with (per_call(DM.trainer, "detection_train_step", kernels) as steps,
                  per_call(DM.ModelAdapter, "detect", kernels) as evals,
                  first_call(DM.trainer, "detection_train_step", keeper(
                      "frcnn", first, lambda a, kw: a[2], lambda r: r[2]))):
                state = DM.main(plan["frcnn"])
            result["frcnn"] = {
                "launches": {k: m.launches for k, m in kernels.items()},
                "per_step": [c["launches"] for c in steps],
                "per_eval_batch": [c["launches"] for c in evals],
                "ms_per_train_step": steady_ms(steps), "ms_per_eval_batch": steady_ms(evals),
                "finite": state is not None,
                "fingerprint": None if state is None else fingerprint(state.model)}
    finally:
        ckpt_lib.CheckpointManager.save_raw = save_raw
    result["first"] = first
    torch.save(result, os.path.join(directory, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def interleave(parts):
    """The global batch of the ranks' batches (rank r's i-th image is image
    r + world i, as data/coco.py:shard_indices deals images out)."""
    out = torch.empty((sum(p.shape[0] for p in parts),) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype)
    for r, p in enumerate(parts):
        out[r::len(parts)] = p
    return out


def ddp_reference_steps(plan, ranks, device):
    """The world-1 step on the ranks' first global batch, from the weights
    each CLI seeds: (YOLO's metrics and gradients, Faster R-CNN's losses and
    gradients), TF32 off."""
    from object_detectors_tpu_torch import detection_main as DM
    from object_detectors_tpu_torch import main as M
    from object_detectors_tpu_torch.models.common import tf32_off
    from object_detectors_tpu_torch.train import optim as optim_lib

    def grads(model):
        return {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                if p.grad is not None}

    on = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x  # noqa: E731
    with tf32_off():
        cfg = M.load_config(M.CONFIG_DIR, plan["yolo"])
        model = M.build_model(cfg).to(device)
        state = M.trainer.create_yolo_train_state(model, M._optimizer(cfg, 1))
        (args, kwargs) = ranks[0]["first"]["yolo"]["batch"]
        batch = [interleave([r["first"]["yolo"]["batch"][0][i] for r in ranks]).to(device)
                 for i in range(5)]
        _, metrics = M.trainer.yolo_train_step_ingest(
            state, *batch, *args[5:], **{k: on(v) for k, v in kwargs.items()})
        yolo = ({k: metrics[k].cpu() for k in ("loss", "sub_losses", "stats")}, grads(model))
        del state, model
        argv = plan["frcnn"]  # the adapter detection_main.main builds from it
        small = "--small" in argv
        ad = DM.ModelAdapter("fasterrcnn_resnet50_fpn", 5,
                             int(argv[argv.index("--image-size") + 1]),
                             resnet_layers=(1, 1, 1, 1) if small else (3, 4, 6, 3), small=small,
                             device=device)
        tx = optim_lib.make_optimizer(optim_lib.OptimizerConfig("sgd", 0.02 / 8, 1e-4, 0.9),
                                      optim_lib.SchedulerConfig())
        state = M.trainer.create_detection_train_state(ad, tx)
        batch = {k: interleave([r["first"]["frcnn"]["batch"][k] for r in ranks]).to(device)
                 for k in ranks[0]["first"]["frcnn"]["batch"]}
        _, _, losses = M.trainer.detection_train_step(
            state, ad, batch, generator=M.trainer.draw_generator(0, 0, device))
        frcnn = ({k: v.cpu() for k, v in losses.items()}, grads(ad.model))
    return yolo, frcnn


def phase_ddp(KR, KB, KN):
    """ddp: data-parallel training over two processes on the one card (gloo:
    NCCL takes one rank a device), yolo_cli416's and frcnn_cli800's
    configurations through the CLIs in float32 with TF32 off (module
    docstring, phase 34). Returns the launches of both ranks by kernel.
    The first step's gradients stand for its update: the Faster R-CNN
    CLI's warmup starts at 1/1000 of its rate, so that update is at the
    float32 rounding of the parameters."""
    import shutil
    import tempfile

    from object_detectors_tpu_torch.train import tiny_steps as TS

    out = os.path.abspath(f"{CLI_OUT}/ddp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    directory = tempfile.mkdtemp(prefix="chip_smoke_ddp")
    plan = {"device": DDP_DEVICE, "yolo": [*DDP_YOLO, f"output_dir={out}/yolo"],
            "frcnn": [*DDP_FRCNN, "--output-dir", f"{out}/frcnn"]}
    with open(os.path.join(directory, "plan.json"), "w") as f:
        json.dump(plan, f)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    logs = [open(f"{out}/rank{r}.log", "w") for r in range(DDP_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *DDP_RANK_COMMAND, str(r), directory],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(DDP_WORLD)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(f"{out}/rank{r}.log") as f:
                print(f.read()[-4000:], file=sys.stderr)
        check(p.returncode == 0, f"ddp rank {r} exited {p.returncode}")
    ranks = [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
             for r in range(DDP_WORLD)]
    shutil.rmtree(directory)

    # only rank 0 writes checkpoints: last and best of the YOLO, model_0 and
    # last of Faster R-CNN
    check(ranks[1]["writes"] == [], f"ddp rank 1 wrote checkpoints {ranks[1]['writes']}")
    check({"yolo/last", "yolo/best", "frcnn/model_0", "frcnn/last"} <= set(ranks[0]["writes"]),
          f"ddp rank 0 wrote {ranks[0]['writes']}")
    for tag in ("yolo/checkpoints/last", "frcnn/checkpoints/last"):
        check(os.path.exists(f"{out}/{tag}.pt"), f"ddp wrote no {tag}.pt")
    # one RoIAlign forward, backward and NMS launch a Faster R-CNN step in
    # each rank; the YOLO's eval batches one NMS launch each
    launches = {k: 0 for k in ("roi_align", "roi_align_bwd", "nms")}
    for r in ranks:
        fr, yo = r["frcnn"], r["yolo"]
        check(fr["finite"], f"ddp rank {r['rank']}'s Faster R-CNN stopped on a non-finite loss")
        check(len(fr["per_step"]) == 16 // (2 * DDP_WORLD) and all(
            c == {"roi_align": 1, "roi_align_bwd": 1, "nms": 1} for c in fr["per_step"]),
            f"ddp rank {r['rank']} Faster R-CNN launches a step: {fr['per_step']}")
        check(len(yo["per_step"]) == 32 // 8 and all(c["nms"] == 0 for c in yo["per_step"])
              and yo["per_eval_batch"] and all(c["nms"] == 1 for c in yo["per_eval_batch"]),
              f"ddp rank {r['rank']} YOLO NMS launches: {yo['per_step']}, "
              f"{yo['per_eval_batch']}")
        for k in launches:
            launches[k] += fr["launches"][k] + yo["launches"][k]
    for run in ("yolo", "frcnn"):
        check(ranks[0][run]["fingerprint"] == ranks[1][run]["fingerprint"],
              f"ddp: the ranks' {run} parameters differ at the end")

    # the first step against one process's on the same global batch
    yolo_ref, frcnn_ref = ddp_reference_steps(plan, ranks, plan["device"])
    shares = [r["first"]["yolo"]["loss_share"] for r in ranks]
    for i, key in enumerate(("loss", "sub_losses", "stats")):
        mean = (shares[0][i] + shares[1][i]) / 2
        emit(phase="ddp", what=f"yolo first step {key}, world 2 against world 1",
             max_abs_err=(mean - yolo_ref[0][key]).abs().max().item(),
             max_abs_ref=yolo_ref[0][key].abs().max().item())
        torch.testing.assert_close(mean, yolo_ref[0][key], rtol=DDP_LOSS_RTOL, atol=1e-6)
    gap = TS.tensor_gap(yolo_ref[1], ranks[0]["first"]["yolo"]["grads"])
    emit(phase="ddp", what="yolo first step gradients, world 2 against world 1", **gap,
         norm_share_tolerance=TS.YOLO_F32_UPDATE_NORM)
    check(gap["norm_share"] <= TS.YOLO_F32_UPDATE_NORM,
          f"ddp: YOLO gradients off by {gap['norm_share']:.3g} of their norm")
    fshares = [r["first"]["frcnn"]["loss_share"] for r in ranks]
    for key, ref in frcnn_ref[0].items():
        mean = (fshares[0][key] + fshares[1][key]) / 2
        check(abs(mean.item() - ref.item()) <= DDP_LOSS_RTOL * abs(ref.item()),
              f"ddp: Faster R-CNN {key} {mean.item()} at world 2, {ref.item()} at world 1")
    gap = TS.tensor_gap(frcnn_ref[1], ranks[0]["first"]["frcnn"]["grads"])
    emit(phase="ddp", what="frcnn first step gradients, world 2 against world 1", **gap,
         worst_share_tolerance=TS.FRCNN_UPDATE_SHARE)
    check(gap["worst_share"] <= TS.FRCNN_UPDATE_SHARE,
          f"ddp: Faster R-CNN gradient of {gap['at']} off by {gap['worst_share']:.3g}")
    drop_weights(out)
    fields = {run: {k: [r[run][k] for r in ranks] for k in ("ms_per_train_step",
                                                             "ms_per_eval_batch")}
              for run in ("yolo", "frcnn")}
    emit(phase="ddp", card=card_line(), world=DDP_WORLD, backend="gloo", seconds=seconds,
         yolo={"batch_per_rank": 8 // DDP_WORLD, "img": 416, **fields["yolo"]},
         frcnn={"batch_per_rank": 2, "img": 800, **fields["frcnn"]}, launches=launches,
         writes_rank0=ranks[0]["writes"])
    return launches


# each analysis timer's arguments in the analysis phase: its default
# (full-width) shapes, few iterations, the kernels' options on
ANALYSIS_TIMERS = {
    "darknet_ablate": ["--iters", "2"],
    "backbone_ablate": ["--iters", "2", "--fused", "--stem-detail"],
    "frcnn_ablate": ["--iters", "2"],
    "retinanet_ablate": ["--iters", "2", "--fused"],
    "rpnfilter_ablate": ["--iters", "2"],
    "roialign_bench": ["--iters", "2"],
    "topk_bench": ["--iters", "2"],
    "decode_bench": ["--iters", "2"],
    "train_ablate": ["--iters", "2"],
    "serving_ablate": [],
}
TIMED_KEYS = ("stage_ms", "variant_ms", "img_per_s", "mrois_per_s")


def positive_times(tree) -> bool:
    """Every number under ``tree`` finite and positive."""
    if isinstance(tree, dict):
        return all(positive_times(v) for v in tree.values())
    return math.isfinite(tree) and tree > 0


def phase_analysis(KR, KN, KF, P):
    """The ten analysis timers' ``main(argv)`` on the card, at their
    default shapes with ``ANALYSIS_TIMERS``' arguments, each with the
    kernels' launch counts set to 0 before it and read after. Each must
    print one JSON line with the card, every time finite and positive, and
    its own checks passed (each timer raises on a failed one; read again
    here): frcnn_ablate's and retinanet_ablate's ``full_pieces`` equal to
    the model's and the pipeline's own call, rpnfilter_ablate's pieces
    equal to ``filter_proposals``, roialign_bench's kernel within the
    RoIAlign gates of its plain version, decode_bench's formulations
    bitwise equal, topk_bench's selections equal; and the launches of the
    kernels on each timer's path. Returns {timer: launches}."""
    import importlib

    kernels = {"roi_align": KR, "nms": KN, "fused_block": KF, "preprocess": P}
    launches = {}
    for timer, argv in ANALYSIS_TIMERS.items():
        module = importlib.import_module(f"object_detectors_tpu_torch.analysis.{timer}")
        for m in kernels.values():
            m.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            module.main(argv)
        seconds = time.perf_counter() - t0
        printed = out.getvalue().strip().splitlines()
        check(len(printed) == 1, f"{timer} printed {len(printed)} lines")
        line = json.loads(printed[0])
        launches[timer] = {k: m.launches for k, m in kernels.items()}
        emit(phase="analysis", seconds=seconds, launches=launches[timer], **line)
        check(line["card"] == card_line(), f"{timer} names the card {line['card']!r}")
        timed = [line[k] for k in TIMED_KEYS if k in line]
        if timer == "serving_ablate":
            timed = [{k: line[k] for k in ("wall_s", "kernel_sum_s", "rpc_cost_ms",
                                            "img_per_s")}]
        check(timed and all(positive_times(t) for t in timed),
              f"{timer} has a time that is not finite and positive")
        got = launches[timer]
        if timer == "backbone_ablate":
            check(got["fused_block"] > 0 and line["fused_launches"] == got["fused_block"],
                  f"backbone_ablate --fused launched the fused kernel {got}")
        if timer == "frcnn_ablate":
            check(line["full_pieces_equal"], "frcnn_ablate's full_pieces differs")
            check(line["launches_per_full_call"] == {"roi_align": 1, "nms": 2},
                  f"frcnn_ablate's full call launched {line['launches_per_full_call']}")
        if timer == "retinanet_ablate":
            check(line["full_pieces_equal"], "retinanet_ablate's full_pieces differs")
            check(line["launches_per_full_call"] == {"nms": 1, "fused_block": 13},
                  f"retinanet_ablate's full call launched {line['launches_per_full_call']}")
        if timer == "rpnfilter_ablate":
            check(line["pieces_equal_filter"] and line["nms_launches_per_full_filter"] == 1,
                  f"rpnfilter_ablate: pieces {line['pieces_equal_filter']}, "
                  f"{line['nms_launches_per_full_filter']} NMS launches a filter")
        if timer == "roialign_bench":
            check(got["roi_align"] > 0 and line["roi_align_launches"] == got["roi_align"],
                  f"roialign_bench launched the RoIAlign kernel {got}")
            check(set(line["kernel_max_abs_err"]) == {"bf16", "f32"},
                  "roialign_bench did not hold both dtypes")
        if timer == "decode_bench":
            check(line["anchor_mismatches"] == 0 and not any(line["box_mismatches"].values()),
                  "decode_bench's formulations differ")
        if timer == "topk_bench":
            check(all(all(v.values()) for v in line["same_selection"].values()),
                  f"topk_bench's selections differ: {line['same_selection']}")
        if timer == "train_ablate":
            check(line["model_unchanged"], "train_ablate changed the model")
        if timer == "serving_ablate":
            flushes = sum(line["flushes"].values())
            check(line["kernel_budget_launches"] == {"preprocess": flushes, "nms": flushes},
                  f"serving_ablate's {flushes} flushes launched "
                  f"{line['kernel_budget_launches']}")
    return launches


def main() -> int:
    emit(phase="device", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, cuda_available=torch.cuda.is_available())
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    card = card_line()
    emit(phase="device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from object_detectors_tpu_torch import bench as B
    from object_detectors_tpu_torch import pipeline as PL
    from object_detectors_tpu_torch import serve as S
    from object_detectors_tpu_torch.kernels import _build
    from object_detectors_tpu_torch.kernels import fused_block as KF
    from object_detectors_tpu_torch.kernels import nms as KN
    from object_detectors_tpu_torch.kernels import preprocess as P
    from object_detectors_tpu_torch.kernels import roi_align as KR
    from object_detectors_tpu_torch.kernels import roi_align_bwd as KB
    from object_detectors_tpu_torch.models import retinanet as RN
    from object_detectors_tpu_torch.models import rpn as RPN
    from object_detectors_tpu_torch.ops import nms as N

    from object_detectors_tpu_torch.eval import native

    sources = ("preprocess", "roi_align", "nms", "fused_block", "coco_eval_core")
    built = {name: not _build.library_path(name).exists() for name in sources}
    t0 = time.perf_counter()
    seconds = _build.build_all(sources)
    for name in sources:
        _build.load_library(name)
        src = _build.source_path(name)
        emit(phase="build", source=str(src.relative_to(_build.CSRC_DIR.parent.parent)),
             compiler=_build.find_nvcc() if src.suffix == ".cu" else _build.find_cxx(),
             built=built[name], seconds=seconds[name])
    native.load()
    emit(phase="build", all_seconds=time.perf_counter() - t0)

    max_err = phase_kernel(P)
    batches, yolo_candidates, yolo_nms, timing = phase_e2e(P, KN, PL)
    phase_consistency(PL, N, batches[0][:2])
    del batches
    _, serving_launches, serving_candidates = phase_serving(B, S, P, KN)
    lvis_launches, lvis_candidates = phase_yolo_lvis(B, PL, N, P, KN)
    cases = {"yolo640 candidates": (*yolo_candidates, NUM_CLASSES, 100),
             "serving YOLO candidates": (*serving_candidates, NUM_CLASSES, 100),
             "yolo_lvis416 candidates": (*lvis_candidates, LVIS_CLASSES, 300)}
    for name in B.NMS_DISTRIBUTIONS:
        boxes, scores, labels = (torch.from_numpy(a).cuda() for a in B.nms_inputs(name))
        cases[f"bench {name}"] = (boxes, scores, labels, None, NUM_CLASSES, 100)
    majority = phase_nms_majority(N, KN, cases)
    latency_nms = phase_nms_latency(B, KN)
    phase_yolo_neck(PL, torch.from_numpy(np.random.RandomState(6).randint(
        0, 255, (2, 320, 320, 3), dtype=np.uint8)).cuda())

    roi_err = phase_roi_align_kernel(KR)
    phase_nms_kernel(KN)
    frcnn_batches, frcnn_launches, roi, nms = phase_frcnn_e2e(PL, P, KR, KN, RPN)
    phase_frcnn_consistency(PL, P, KR, KN, RPN, frcnn_batches[0][:1])

    fused_err, fused_per_forward, fused_times = phase_fused_block_kernel(KF)
    retina_batches, retina_launches = phase_retinanet_e2e(PL, P, KN, KF)
    frcnn_fused = phase_frcnn_fused(PL, P, KF, frcnn_batches[0])
    del frcnn_batches
    anchors = PL.build_retinanet_pipeline_uint8(num_classes=RETINA_CLASSES, img_size=IMG,
                                                device="cuda").anchors
    retina_nms = phase_retinanet_post(RN, KN, anchors)
    phase_retinanet_consistency(PL, P, retina_batches[0][:1])

    bwd_err, bwd_timing = phase_roi_align_backward_kernel(KR, KB)
    yolo_train = phase_yolo_train(B)
    frcnn_train = phase_frcnn_train(KR, KB, KN)

    protocol_nms = phase_protocol(B, PL, N, KN)
    phase_protocol_trained(B)
    planted_nms = phase_eval_planted(N, KN, P)
    phase_ingest(P)

    from object_detectors_tpu_torch import detection_main as DM

    dm = {"maskrcnn800": phase_rcnn_branch_eval(DM, KR, KN, "maskrcnn_resnet50_fpn",
                                                "maskrcnn800"),
          "maskrcnn_train800": phase_dm_train(DM, KR, KB, KN, "maskrcnn_resnet50_fpn",
                                              "maskrcnn_train800", per_step=(2, 2, 1)),
          "kprcnn800": phase_rcnn_branch_eval(DM, KR, KN, "keypointrcnn_resnet50_fpn",
                                              "kprcnn800"),
          "kprcnn_train800": phase_dm_train(DM, KR, KB, KN, "keypointrcnn_resnet50_fpn",
                                            "kprcnn_train800", per_step=(2, 2, 1)),
          "ssd300": phase_ssd300(DM, KN),
          "ssd_train300": phase_dm_train(DM, KR, KB, KN, "ssd300_vgg16", "ssd_train300",
                                         size=SSD_IMG),
          "retinanet_train800": phase_dm_train(DM, KR, KB, KN, "retinanet_resnet50_fpn",
                                               "retinanet_train800")}
    emit(phase="detection_main", ms={k: v.get("ms_per_batch", v.get("ms_per_step"))
                                     for k, v in dm.items()})
    yolo_cli = phase_yolo_cli(N, KN)
    frcnn_cli = phase_frcnn_cli(KR, KB, KN)
    ddp = phase_ddp(KR, KB, KN)
    analysis = phase_analysis(KR, KN, KF, P)

    branches = ("maskrcnn800", "kprcnn800")
    trains = ("maskrcnn_train800", "kprcnn_train800")
    roi["max_abs_err"] = max(roi["max_abs_err"], roi_err,
                             *(dm[p]["max_abs_err"] for p in branches))
    roi["launches_by_path"] = {"frcnn640": roi["launches"],
                               "frcnn_train800": frcnn_train["launches"]["roi_align"],
                               **{p: dm[p]["launches"]["roi_align"] for p in branches + trains},
                               "frcnn_cli800": frcnn_cli["launches"]["roi_align"],
                               "ddp": ddp["roi_align"],
                             **{f"analysis {t}": analysis[t]["roi_align"]
                                for t in ("frcnn_ablate", "roialign_bench")}}
    roi["branch_14x14"] = {p: dm[p]["roi_align_14x14"] for p in branches}
    roi["launches"] = sum(roi["launches_by_path"].values())
    retina_pre = sum(retina_launches[mode]["preprocess"] for mode in retina_launches)
    retina_nms_launches = sum(retina_launches[mode]["nms"] for mode in retina_launches)
    nms["launches_by_path"] = {"yolo640": yolo_nms, "serving": serving_launches["nms"],
                               "yolo_lvis416": lvis_launches["nms"],
                               "nms_p50_latency": latency_nms,
                               "frcnn640": frcnn_launches["nms"],
                               "retinanet640": retina_nms_launches,
                               "frcnn_train800": frcnn_train["launches"]["nms"],
                               "protocol": protocol_nms, "eval_planted": planted_nms,
                               **{p: dm[p]["launches"]["nms"] for p in branches + trains},
                               "ssd300": dm["ssd300"]["launches"],
                               "yolo_cli416": yolo_cli["launches"],
                               "frcnn_cli800": frcnn_cli["launches"]["nms"],
                               "ddp": ddp["nms"],
                               **{f"analysis {t}": analysis[t]["nms"]
                                  for t in ("frcnn_ablate", "retinanet_ablate",
                                            "rpnfilter_ablate", "serving_ablate")}}
    nms["launches"] = sum(nms["launches_by_path"].values())
    nms["frcnn_train800_rpn_shape"] = {key: frcnn_train["nms"][key] for key in MEASURED_NMS
                                       if key in frcnn_train["nms"]}
    nms["retinanet_postprocess_shape"] = retina_nms
    nms["ssd300_postprocess_shape"] = dm["ssd300"]["nms"]
    nms["nms_majority_calls"] = majority
    kernels = [{
        "name": "preprocess_u8_bf16", "route": "cuda",
        "source": "object_detectors_tpu_torch/csrc/preprocess.cu",
        "replaces": "object_detectors_tpu/kernels/preprocess.py:33",
        "launches": (timing["launches"] + serving_launches["preprocess"]
                     + lvis_launches["preprocess"] + frcnn_launches["preprocess"] + retina_pre
                     + analysis["serving_ablate"]["preprocess"]),
        "launches_by_path": {"yolo640": timing["launches"],
                             "serving": serving_launches["preprocess"],
                             "yolo_lvis416": lvis_launches["preprocess"],
                             "frcnn640": frcnn_launches["preprocess"],
                             "retinanet640": retina_pre,
                             "analysis serving_ablate": analysis["serving_ablate"]["preprocess"]},
        "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }, {
        "name": "multiscale_roi_align_fwd", "route": "cuda",
        "source": "object_detectors_tpu_torch/csrc/roi_align.cu",
        "replaces": "object_detectors_tpu/kernels/roi_align_pallas.py:1388 "
                    "(and the :880, :659, :435 variants of the same function)",
        **roi,
        "library_ms": None,  # no single PyTorch call; torchvision is not a dependency
    }, {
        "name": "greedy_nms", "route": "cuda",
        "source": "object_detectors_tpu_torch/csrc/nms.cu",
        "replaces": "object_detectors_tpu/kernels/nms_pallas.py:94",
        **nms,
        "library_ms": None,  # no single PyTorch call; torchvision is not a dependency
    }, {
        "name": "fused_bottleneck", "route": "cuda",
        "source": "object_detectors_tpu_torch/csrc/fused_block.cu",
        "replaces": "object_detectors_tpu/kernels/fused_block.py:180",
        "launches": (retina_launches["auto"]["fused_block"]
                     + analysis["backbone_ablate"]["fused_block"]
                     + analysis["retinanet_ablate"]["fused_block"]),
        "launches_by_path": {"retinanet640 (backbone_fused=auto)":
                             retina_launches["auto"]["fused_block"],
                             "frcnn640 backbone (backbone_fused=auto)":
                             frcnn_fused["fused_launches_per_forward"],
                             **{f"analysis {t} --fused": analysis[t]["fused_block"]
                                for t in ("backbone_ablate", "retinanet_ablate")}},
        "max_abs_err": fused_err,
        **fused_per_forward,
        "per_shape": [{key: t[key] for key in ("shape", "count", "ms", "plain_ms", "library_ms",
                                               "bound_ms", "bound_by")} for t in fused_times],
        "frcnn640_backbone": frcnn_fused,
        # library_ms: the unfused cuDNN Bottleneck at the same shapes (no
        # single PyTorch call computes a whole block)
    }, {
        "name": "multiscale_roi_align_bwd", "route": "cuda",
        "source": "object_detectors_tpu_torch/csrc/roi_align.cu",
        "replaces": "object_detectors_tpu/ops/roi_align.py:381 (XLA VJP, no pallas_call)",
        "launches": (frcnn_train["launches"]["roi_align_bwd"]
                     + sum(dm[p]["launches"]["roi_align_bwd"] for p in trains)
                     + frcnn_cli["launches"]["roi_align_bwd"] + ddp["roi_align_bwd"]),
        "launches_by_path": {"frcnn_train800": frcnn_train["launches"]["roi_align_bwd"],
                             **{p: dm[p]["launches"]["roi_align_bwd"] for p in trains},
                             "frcnn_cli800": frcnn_cli["launches"]["roi_align_bwd"],
                             "ddp": ddp["roi_align_bwd"]},
        "max_abs_err": max(bwd_err, *(dm[p]["max_abs_err"] for p in trains)),
        **bwd_timing["torch.float32"],  # Faster R-CNN trains in f32
        "bf16": bwd_timing["torch.bfloat16"],
        "frcnn_train800_own_inputs": {
            dtype: {key: t[key] for key in ("ms", "zeroing_ms", "kernel_only_ms", "device_ms",
                                            "bound_ms", "staged_rois", "direct_rois")}
            for dtype, t in frcnn_train["roi_align_bwd"].items()},
        "branch_14x14_own_inputs": {p: dm[p]["roi_align_bwd_14x14"] for p in trains},
        "library_ms": None,  # no single PyTorch call computes this function
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:  # a rank of the ddp phase, started by it
        sys.exit(ddp_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
