"""Bench of the port on one NVIDIA GPU (port of the root ``bench.py``).

    python -m object_detectors_tpu_torch.bench [--quick] [--configs ...]
    python -m object_detectors_tpu_torch.bench --protocol [--batch-sizes ...]

Rows, each on seeded random weights and its own seeded uint8 batches:

1. yolo640: YOLOv3 640² end to end (uint8 in, normalize kernel, Darknet-53,
   top-256, decode, majority-vote NMS), batch 128 (``--quick``: 4;
   ``--full``: 2 to 128; ``--batch-sizes``);
2. retinanet640: RetinaNet R50-FPN, batch 16, backbone unfused;
3. frcnn640: Faster R-CNN R50-FPN, batch 16;
4. yolo_lvis416: YOLOv3 with 1203 LVIS classes at 416², batch 16, top-300,
   300 detections, IoU 0.6, conf 0.1;
5. serving: 256 requests of YOLO and RetinaNet at 4:1 through
   ``serve.BatchedDetectionServer``, flushes of 64 and 16, a pool of 32
   images on the card;
6. nms_p50_latency: ``nms_majority`` alone at batch 512, 256 candidates, 80
   classes, 100 detections, on uniform, clustered and adversarial boxes;
7. yolo_train416: the YOLOv3 train step (``train/trainer.py``: forward in
   train mode, loss, backward, SGD at lr 1e-3 with momentum 0.9), Darknet-53
   with 80 classes at 416², bf16 activations and f32 parameters, batch 128,
   three pre-staged float batches of 32 GT slots, 2 warm-up steps, 10 timed
   steps and one host read of the last loss (runs by default, as in the
   root bench, not with ``--quick`` or ``--configs`` unless named there as
   ``train_step``).

Timing as the reference: distinct uint8 batches staged on the card before
the timed window, back-to-back calls, one host read of the last output at
the end; host-to-device copies are outside it, the cast and normalize
inside. Prints one JSON line: ``metric``, ``value``, ``unit``, ``configs``,
``e2e``, ``device``, and ``card`` (nvidia-smi's name and power limit, also
in every row). Left out: ``vs_baseline`` (it divides by a TPU target).

``--protocol`` runs the reference's accuracy-and-latency protocol instead
(``run_protocol``, the root bench's): per batch size of the ladder 2, 4, 8,
16, 32, 64, 128 (``--batch-sizes``), two runs over 256 synthetic COCO-format
images at 416² (seeded random uint8 images, 80 classes, labels 0-based as
LVIS's) through ``data.coco.yolo_batches`` (host resize, here the identity,
and normalize), full-width YOLOv3 (Darknet-53, 80 classes, bf16, top-256,
100 detections, conf 0.1, IoU 0.6: ``nms_majority`` on the NMS kernel) and
``eval.evaluator.DetectionEvaluator`` (COCO protocol, native matcher). Each
run is a CSV row: ``forw_time`` (the pipeline calls, each to its outputs
being ready on the device: one synchronize a batch, as JAX's
``block_until_ready``), ``cpu_time`` (``summarize``), ``app_time`` (the whole
run: host batches, pipeline, host copies, evaluation) and ``map``; the
returned rows also carry ``detections`` and ``img_size``. The CSV goes to
``output/benchmark_res.csv``; the printed line has ``metric``
("benchmark_protocol"), ``value`` (the last row's mAP), ``unit``, ``rows``,
``weights`` and ``card``. As the root bench does, the protocol scores the
trained artifact when ``analysis/make_artifacts.py`` has written one
(``output/artifacts_torch/synthetic_yolo.pt`` with its sidecar): its
renderable 96² set at the artifact's size, top-64, 20 detections
(``"weights": "trained"``); otherwise the seeded full-width YOLOv3 above
(``"weights": "seeded"``).

``--device`` (default ``cuda``) is the protocol's device; ``cpu`` runs it
on the CPU (the tests do), where ``card`` reads "none". The rows run on
the card.

``mfu`` of a row is the floating-point operations that
``torch.utils.flop_counter.FlopCounterMode`` counts over one call, divided
by the time of a call and the H100 SXM's dense bf16 tensor-core peak. The
count sees the matrix products and convolutions PyTorch runs (for
yolo_train416 those of one whole step, forward and backward); it misses the
kernels launched through ctypes (normalize, NMS, RoIAlign and, off in every
row, the fused bottleneck) and all elementwise work.

A row that fails raises; the run then prints no line.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from object_detectors_tpu_torch import serve as S
from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
from object_detectors_tpu_torch.ops.nms import nms_majority
from object_detectors_tpu_torch.pipeline import (
    build_frcnn_pipeline_uint8, build_pipeline, build_pipeline_uint8,
)
from object_detectors_tpu_torch.train import optim
from object_detectors_tpu_torch.train import trainer

BF16_PEAK_FLOPS = 989.4e12  # H100 SXM dense bf16 tensor cores, published
PROTOCOL_LADDER = (2, 4, 8, 16, 32, 64, 128)
PROTOCOL_CSV = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "output", "benchmark_res.csv")
PROTOCOL_FIELDS = ("batch", "forw_time", "cpu_time", "app_time", "map")


def card_line(device="cuda") -> str:
    """The card's name and power limit as nvidia-smi gives them; "none"
    for a CPU device."""
    if torch.device(device).type != "cuda":
        return "none"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _graph_flops(infer, *example) -> float | None:
    """The operations FlopCounterMode counts over one call (module docstring)."""
    with FlopCounterMode(display=False) as counter:
        infer(*example)
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


def _mfu(flops, dt):
    if flops is None or not dt:
        return None
    return flops / dt / BF16_PEAK_FLOPS


def _timed_stream(infer, host_batches, warmup=2, iters=10, device="cuda"):
    """Seconds a call: the batches go to the device outside the timed
    window; ``warmup`` calls and a host read, then ``iters`` back-to-back
    calls cycling through the batches and one host read of the last
    output."""
    dev_batches = [torch.as_tensor(b).to(device) for b in host_batches]
    for i in range(warmup):
        out = infer(dev_batches[i % len(dev_batches)])
    float(out[1].sum())  # host read
    t0 = time.perf_counter()
    outs = []
    for i in range(iters):
        outs.append(infer(dev_batches[i % len(dev_batches)]))
    float(outs[-1][1].sum())  # one final host read
    return (time.perf_counter() - t0) / iters


def _uint8_batches(seed: int, bs: int, img_size: int):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (bs, img_size, img_size, 3), dtype=np.uint8)
            for _ in range(3)]


def run(batch_sizes=(64,), img_size=640, warmup=2, iters=10, uint8=True, device="cuda"):
    """yolo640: (best images/s, {batch: images/s}, mfu at the best batch)."""
    build = build_pipeline_uint8 if uint8 else build_pipeline
    infer = build(img_size=img_size, device=device)
    best, best_mfu, results = 0.0, None, {}
    rng = np.random.RandomState(0)
    for bs in batch_sizes:
        if uint8:
            batches = [rng.randint(0, 255, (bs, img_size, img_size, 3), dtype=np.uint8)
                       for _ in range(3)]
        else:
            batches = [torch.from_numpy(rng.rand(bs, img_size, img_size, 3).astype(np.float32))
                       .to(torch.bfloat16) for _ in range(3)]
        dt = _timed_stream(infer, batches, warmup, iters, device)
        ips = bs / dt
        results[bs] = ips
        if ips >= best:
            best_mfu = _mfu(_graph_flops(infer, torch.as_tensor(batches[0]).to(device)), dt)
        best = max(best, ips)
    return best, results, best_mfu


def _run_row(infer, seed, bs, img_size, warmup, iters, device):
    """(images/s, mfu) of one pipeline on its seeded uint8 batches."""
    batches = _uint8_batches(seed, bs, img_size)
    dt = _timed_stream(infer, batches, warmup, iters, device)
    return bs / dt, _mfu(_graph_flops(infer, torch.from_numpy(batches[0]).to(device)), dt)


def train_batches(bs: int, img_size: int, num_classes: int = 80, slots: int = 32,
                  seed: int = 3):
    """The train row's three batches, as the root bench draws them: images
    uniform in [0, 1), GT boxes (relative cxcywh) in [0.25, 0.75), labels
    below ``num_classes``, each slot valid with probability one half."""
    rng = np.random.RandomState(seed)
    return [dict(images=rng.rand(bs, img_size, img_size, 3).astype(np.float32),
                 gt_boxes=rng.rand(bs, slots, 4).astype(np.float32) * 0.5 + 0.25,
                 gt_labels=rng.randint(0, num_classes, (bs, slots)),
                 gt_valid=rng.rand(bs, slots) < 0.5) for _ in range(3)]


def yolo_train_setup(bs=128, img_size=416, device="cuda", model=None):
    """(state, loss configuration, the three batches on ``device``) of
    yolo_train416, as the root bench's run_train_step sets it up: its
    optimizer is optax.sgd(1e-3, momentum=0.9), no weight decay and a
    constant rate. ``model`` defaults to Darknet-53 YOLOv3 with 80 classes,
    bf16 activations, seeded random weights."""
    num_classes = 80
    model = model or init_yolo_(YoloHead(num_classes, dtype=torch.bfloat16), seed=0)
    tx = optim.make_optimizer(optim.OptimizerConfig("sgd", 1e-3, weight_decay=0.0,
                                                    momentum=0.9),
                              optim.SchedulerConfig())  # constant for 100 steps
    batches = [{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}
               for b in train_batches(bs, img_size, num_classes)]
    return (trainer.create_yolo_train_state(model, tx, device),
            YC.YoloLossConfig(num_classes=num_classes, img_size=img_size), batches)


def train_step_timing(bs=128, img_size=416, warmup=2, iters=10, device="cuda",
                      model=None):
    """yolo_train416 with its readings: images/s, ms a step, mfu (the
    FlopCounterMode count of one step, forward and backward), the peak
    device memory of the timed steps (``torch.cuda.max_memory_allocated``;
    None on the CPU) and the last loss."""
    state, cfg, batches = yolo_train_setup(bs, img_size, device, model)

    def step(b):
        return trainer.yolo_train_step(state, b["images"], b["gt_boxes"], b["gt_labels"],
                                       b["gt_valid"], cfg, cfg.num_classes)[1]["loss"]

    for i in range(warmup):
        loss = step(batches[i % 3])
    float(loss)  # host read
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(iters):
        loss = step(batches[i % 3])
    last = float(loss)  # one final host read
    dt = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    return {"imgs_per_s": bs / dt, "ms_per_step": dt * 1e3,
            "mfu": _mfu(_graph_flops(step, batches[0]), dt), "max_memory_gb": peak,
            "loss": last}


def run_train_step(bs=128, img_size=416, warmup=2, iters=10, device="cuda"):
    """yolo_train416: (images/s, mfu)."""
    t = train_step_timing(bs, img_size, warmup, iters, device)
    return t["imgs_per_s"], t["mfu"]


def run_retinanet(bs=16, img_size=640, warmup=2, iters=8, device="cuda"):
    """retinanet640: RetinaNet R50-FPN, uint8 end to end, backbone unfused."""
    infer = S.build_retinanet_pipeline(img_size=img_size, uint8_input=True, device=device)
    return _run_row(infer, 1, bs, img_size, warmup, iters, device)


def run_frcnn(bs=16, img_size=640, warmup=2, iters=8, device="cuda"):
    """frcnn640: Faster R-CNN R50-FPN, uint8 end to end."""
    infer = build_frcnn_pipeline_uint8(img_size=img_size, device=device)
    return _run_row(infer, 2, bs, img_size, warmup, iters, device)


def run_yolo_lvis(bs=16, img_size=416, warmup=2, iters=8, num_classes=1203, topk=300,
                  device="cuda"):
    """yolo_lvis416: YOLOv3 with the 1203 LVIS classes, majority-vote NMS
    over 300 candidates to 300 detections (IoU 0.6, conf 0.1)."""
    infer = build_pipeline_uint8(num_classes, img_size, topk=topk, max_det=300, device=device)
    return _run_row(infer, 3, bs, img_size, warmup, iters, device)


def run_serving(n_requests=256, img_size=640, yolo_bs=64, retina_bs=16, device="cuda",
                pipelines=None):
    """serving: the mixed YOLO + RetinaNet stream through the batched
    server (uint8 requests as slots of a 32-image pool on the device, up to
    four flushes in flight). ``pipelines``: {"yolo", "retinanet"} to serve;
    None builds the full-width ones. A warm-up stream of the first
    ``yolo_bs + retina_bs`` requests runs first. Returns (images/s, the
    timed stream's responses, the server, whose ``flushes`` count the timed
    stream's)."""
    if pipelines is None:
        pipelines = {
            "yolo": S.build_yolo_pipeline(img_size=img_size, batch_size=yolo_bs,
                                          uint8_input=True, device=device),
            "retinanet": S.build_retinanet_pipeline(img_size=img_size, uint8_input=True,
                                                    device=device),
        }
    server = S.BatchedDetectionServer(pipelines, {"yolo": yolo_bs, "retinanet": retina_bs},
                                      input_dtype=torch.uint8, device=device)
    rng = np.random.RandomState(4)
    server.stage_pool(rng.randint(0, 255, (32, img_size, img_size, 3), dtype=np.uint8))
    reqs = [S.Request(i, "yolo" if i % 5 else "retinanet", i % 32) for i in range(n_requests)]
    server.run_stream(reqs[: yolo_bs + retina_bs])  # warm-up
    server.flushes = dict.fromkeys(server.flushes, 0)
    t0 = time.perf_counter()
    out = server.run_stream(reqs)
    dt = time.perf_counter() - t0
    if len(out) != n_requests:
        raise RuntimeError(f"the serving stream answered {len(out)} of {n_requests} requests")
    return n_requests / dt, out, server


def nms_uniform(rng, bs, n_cand):
    xy = rng.rand(bs, n_cand, 2) * 600
    wh = rng.rand(bs, n_cand, 2) * 120 + 1
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def nms_clustered(rng, bs, n_cand):
    """Crowded-scene candidates: about 12 dense clusters an image, so deep
    suppression chains."""
    centers = rng.rand(bs, 12, 2) * 560 + 40
    assign = rng.randint(0, 12, (bs, n_cand))
    cxy = np.take_along_axis(centers, assign[..., None], axis=1)
    jitter = rng.randn(bs, n_cand, 2) * 10
    wh = rng.rand(bs, n_cand, 2) * 40 + 40
    xy = cxy + jitter - wh / 2
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def nms_adversarial(rng, bs, n_cand):
    """Worst-case suppression chain: box i overlaps box i+1 at IoU 8/12 =
    0.67 > 0.6 but box i+2 at 6/14 = 0.43 < 0.6, and the scores descend
    along the chain, so greedy keeps 0, 2, 4, ... (chain depth n_cand / 2).
    Returns (boxes, scores)."""
    x = np.arange(n_cand, dtype=np.float32) * 2.0
    one = np.stack([x, np.zeros_like(x), x + 10, np.full_like(x, 10.0)], -1)
    boxes = np.tile(one[None], (bs, 1, 1))
    scores = np.tile(np.linspace(1.0, 0.5, n_cand, dtype=np.float32)[None], (bs, 1))
    return boxes, scores


NMS_DISTRIBUTIONS = {"uniform": nms_uniform, "clustered": nms_clustered,
                     "adversarial": nms_adversarial}


def nms_inputs(name, bs=512, n_cand=256, num_classes=80):
    """The reference's candidates of one distribution, from its seed 5:
    numpy (boxes [bs, n, 4] f32, scores [bs, n] f32, labels [bs, n])."""
    rng = np.random.RandomState(5)
    out = NMS_DISTRIBUTIONS[name](rng, bs, n_cand)
    if isinstance(out, tuple):
        boxes, scores = out
    else:
        boxes, scores = out, rng.rand(bs, n_cand).astype(np.float32)
    return boxes, scores, rng.randint(0, num_classes, (bs, n_cand))


def run_nms_latency(bs=512, n_cand=256, max_det=100, num_classes=80, iters=20, device="cuda"):
    """nms_p50_latency: batched majority-vote NMS alone on candidates on the
    device: per distribution, 3 warm-up calls, then 7 samples of ``iters``
    back-to-back calls ending in a host read; the median and the largest
    sample's mean call time over the batch, in microseconds an image (a
    sample is a mean over ``iters`` calls, so its largest is a max of
    means, not a p99)."""
    results = {}
    for name in NMS_DISTRIBUTIONS:
        boxes, scores, labels = (torch.from_numpy(a).to(device)
                                 for a in nms_inputs(name, bs, n_cand, num_classes))

        def f():
            return nms_majority(boxes, scores, labels, num_classes, 0.6, max_det)

        for _ in range(3):
            out = f()
        float(out[1].sum())
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            outs = [f() for _ in range(iters)]
            float(outs[-1][1].sum())
            times.append((time.perf_counter() - t0) / iters)
        times = np.sort(times)
        results[name] = {"p50_us": float(np.median(times)) / bs * 1e6,
                         "max_mean_us": float(times[-1]) / bs * 1e6}
    return results


def protocol_set(num_images=256, img_size=416, num_classes=None):
    """The protocol's synthetic COCO-format set (labels 0-based, as LVIS's)
    and its dataset. Without ``num_classes``: ``num_images`` seeded random
    uint8 images of ``img_size``² with 80 classes. With it: the trained
    branch's renderable set (96² images, seed 1)."""
    from object_detectors_tpu_torch.data import coco as D
    from object_detectors_tpu_torch.data import synthetic

    if num_classes is not None:
        gt, loader = synthetic.renderable_dataset(
            np.random.RandomState(1), num_images=num_images, img_size=96,
            num_classes=num_classes)
    else:
        gt = synthetic.make_coco_dicts(np.random.RandomState(0), num_images=num_images,
                                       img_size=img_size, num_classes=80)
        imgs = {im["id"]: np.random.RandomState(im["id"]).randint(
            0, 255, (img_size, img_size, 3)).astype(np.uint8) for im in gt["images"]}

        def loader(info):
            return imgs[info["id"]]
    return gt, D.CocoDetectionDataset(gt, label_mode="lvis0", image_loader=loader)


def run_protocol(batch_sizes=PROTOCOL_LADDER, img_size=416, num_images=256,
                 out_csv=PROTOCOL_CSV, runs=2, device="cuda", model=None, meta=None):
    """The reference benchmark protocol (the root ``bench.py:run_protocol``):
    per batch size ``runs`` timed runs over the whole synthetic set, each a
    CSV row (module docstring). The warm-up call of each batch size is
    outside the timed window.

    Without ``model``: 256 seeded random 416² images of a synthetic COCO
    set with 80 classes and the full-width seeded YOLOv3 of
    ``build_pipeline(img_size=img_size)``. With ``model`` (a ``YoloHead``,
    e.g. trained weights carried over from the JAX package) and ``meta``
    ({"img_size", "num_classes", "backbone_layers"}): the JAX protocol's
    trained branch, the renderable synthetic set (96² images, seed 1)
    scored at ``meta["img_size"]`` with top-64 and 20 detections. Returns
    the rows."""
    from object_detectors_tpu_torch.data import coco as D
    from object_detectors_tpu_torch.eval import evaluator as E
    from object_detectors_tpu_torch.eval import native

    dev = resolve_device(device)
    native.load()  # the matcher's build stays out of the first row's cpu_time
    if model is not None:
        img_size = meta["img_size"]
        gt, ds = protocol_set(num_images, num_classes=meta["num_classes"])
        pipe = build_pipeline(num_classes=meta["num_classes"], img_size=img_size, topk=64,
                              max_det=20, model=model, device=dev)
    else:
        gt, ds = protocol_set(num_images, img_size)
        pipe = build_pipeline(img_size=img_size, device=dev)

    def ready():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    for bs in batch_sizes:
        pipe(torch.zeros((bs, img_size, img_size, 3), dtype=pipe.dtype, device=dev))
        ready()  # warm-up, outside the app window
        for _ in range(runs):
            t_app0 = time.perf_counter()
            forw = 0.0
            ev = E.DetectionEvaluator(gt, label_map=lambda c: c + 1)
            for batch in D.yolo_batches(ds, bs, img_size, max_boxes=8):
                x = torch.from_numpy(batch["images"]).to(dev).to(pipe.dtype)
                t0 = time.perf_counter()
                out = pipe(x)
                ready()
                forw += time.perf_counter() - t0
                n = int((batch["image_ids"] >= 0).sum())  # the filled slots come last
                ev.update(batch["image_ids"][:n], *(o[:n] for o in out),
                          batch["scale_factors"][:n])
            t0 = time.perf_counter()
            stats = ev.summarize()
            cpu_eval = time.perf_counter() - t0
            app = time.perf_counter() - t_app0
            rows.append({"batch": bs, "forw_time": round(forw, 3),
                         "cpu_time": round(cpu_eval, 3), "app_time": round(app, 3),
                         "map": round(float(stats[0]), 5), "detections": len(ev.results),
                         "img_size": img_size})
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=PROTOCOL_FIELDS, extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="single small batch size for smoke runs")
    ap.add_argument("--full", action="store_true", help="batch sweep 2 to 128")
    ap.add_argument("--configs", nargs="*", default=None,
                    help="subset of {yolo640,retinanet640,frcnn640,yolo_lvis416,train_step,"
                         "serving}; default: all six")
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--batch-sizes", type=int, nargs="*", default=None)
    ap.add_argument("--device-resident", action="store_true",
                    help="normalized bf16 batches on the card instead of uint8")
    ap.add_argument("--protocol", action="store_true",
                    help="the reference benchmark protocol instead of the rows: 256 "
                         "synthetic 416² images through full-width YOLOv3, NMS and the "
                         "COCO evaluator, two runs per batch size of 2 to 128 "
                         "(--batch-sizes); timing and mAP rows to output/benchmark_res.csv; "
                         "the trained artifact of analysis/make_artifacts.py when present")
    ap.add_argument("--device", default="cuda",
                    help="the protocol's device: cuda (default) or cpu; the rows run on "
                         "the card")
    args = ap.parse_args(argv)

    if args.protocol:
        from object_detectors_tpu_torch.analysis.make_artifacts import load_yolo_artifact

        device = resolve_device(args.device)
        card = card_line(device)
        model, meta = load_yolo_artifact(device)
        rows = run_protocol(tuple(args.batch_sizes or PROTOCOL_LADDER), device=device,
                            model=model, meta=meta)
        print(json.dumps({"metric": "benchmark_protocol", "value": rows[-1]["map"],
                          "unit": "mAP", "rows": rows,
                          "weights": "seeded" if model is None else "trained",
                          "card": card}))
        return

    if args.batch_sizes:
        sizes = tuple(args.batch_sizes)
    elif args.quick:
        sizes = (4,)
    elif args.full:
        sizes = (2, 4, 8, 16, 32, 64, 128)
    else:
        sizes = (128,)
    wanted = args.configs or ["yolo640", "retinanet640", "frcnn640", "yolo_lvis416", "serving"]
    if args.quick:
        wanted = args.configs or ["yolo640"]

    card = card_line()
    configs = {}
    best, results, ymfu = run(sizes, args.img_size, uint8=not args.device_resident)
    configs["yolo640"] = {"value": best, "mfu": ymfu,
                          "per_batch": {str(k): v for k, v in results.items()}}
    if "retinanet640" in wanted:
        v, m = run_retinanet()
        configs["retinanet640"] = {"value": v, "mfu": m}
    if "frcnn640" in wanted:
        v, m = run_frcnn()
        configs["frcnn640"] = {"value": v, "mfu": m}
    if "yolo_lvis416" in wanted:
        v, m = run_yolo_lvis()
        configs["yolo_lvis416"] = {"value": v, "mfu": m}
    if "train_step" in wanted or (args.configs is None and not args.quick):
        v, m = run_train_step()
        configs["yolo_train416"] = {"value": v, "mfu": m}
    if not args.quick:
        nms_res = run_nms_latency()
        configs["nms_p50_latency"] = {"value": nms_res["uniform"]["p50_us"],
                                      "unit": "us/image", "distributions": nms_res}
    if "serving" in wanted:
        configs["serving"] = {"value": run_serving()[0]}
    for row in configs.values():
        row["card"] = card

    print(json.dumps({
        "metric": f"yolov3_{args.img_size}sq_e2e_uint8_throughput",
        "value": configs["yolo640"]["value"],
        "unit": "images/sec/chip",
        "configs": configs,
        "e2e": ("uint8 batches staged on the card before the timed window; the "
                "normalize kernel and the whole graph inside it; host-to-device "
                "copies excluded" if not args.device_resident else "device-resident"),
        "device": "cuda",
        "card": card,
    }))


if __name__ == "__main__":
    main()
