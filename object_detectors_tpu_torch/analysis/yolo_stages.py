"""Where the time of the YOLOv3-640 serving path goes on one GPU.

    python -m object_detectors_tpu_torch.analysis.yolo_stages [--out DIR]

Full-width YOLOv3 (Darknet-53, 80 classes, 640², bf16, seeded random
weights) through the uint8 pipeline at batch 64 on three distinct
pre-staged batches:

* per-stage device time with CUDA events around each stage of the pipeline
  (normalize kernel, network, score + top-k + decode, majority NMS), mean
  of 10 calls after one warm-up; the whole call's rate is chip_smoke.py's
  e2e phase;
* a torch.profiler trace of a few calls: device busy share of the window and
  the kernels that take the most device time;
* the network's FLOPs (torch.utils.flop_counter) and its share of the bf16
  tensor-core peak.

Prints one JSON line; the Chrome trace goes to ``DIR/yolo_stages_trace.json``
when ``--out`` is given. Needs a GPU.

The analysis timers share this module's helpers: ``time_calls`` and
``prefix_times`` (back-to-back calls, one synchronization at the end),
``run_through`` (a call cut at one of its ``on_stage`` marks) and
``timer_line`` (the one JSON line with the card).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from object_detectors_tpu_torch.kernels.preprocess import preprocess_images
from object_detectors_tpu_torch.pipeline import build_pipeline_uint8

BATCH, ITERS = 64, 10
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16, published


def stage_times(pipe, batches, iters):
    names = ("preprocess", "network", "select", "nms")
    totals = dict.fromkeys(names, 0.0)
    with torch.inference_mode():
        for i in range(iters + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            x = preprocess_images(batches[i % len(batches)], pipe.dtype)
            ev[1].record()
            outs = pipe.model(x)
            ev[2].record()
            cand = pipe.select(outs)
            ev[3].record()
            pipe.nms(*cand)
            ev[4].record()
            torch.cuda.synchronize()
            if i:  # the first round warms up
                for k, name in enumerate(names):
                    totals[name] += ev[k].elapsed_time(ev[k + 1])
    return {name: t / iters for name, t in totals.items()}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, *args, warmup: int = 2, iters: int = 10, device="cuda") -> float:
    """Seconds a call of ``fn(*args)``: ``warmup`` calls and a
    synchronization, then ``iters`` back-to-back calls and one
    synchronization at the end (eager PyTorch runs every call's work, so
    nothing is reduced to a scalar to keep it)."""
    for _ in range(warmup):
        fn(*args)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    synchronize(device)
    return (time.perf_counter() - t0) / iters


def prefix_times(stages: dict, *args, warmup: int = 2, iters: int = 10, device="cuda"):
    """{name: ms a call} of each stage (``time_calls``) and {name: ms over
    the stage before}, in the order of ``stages``."""
    ms, marginal, prev = {}, {}, 0.0
    for name, fn in stages.items():
        ms[name] = time_calls(fn, *args, warmup=warmup, iters=iters, device=device) * 1e3
        marginal[name] = ms[name] - prev
        prev = ms[name]
    return ms, marginal


class _Stop(Exception):
    pass


def run_through(fn, stage: str, *args, **kwargs) -> None:
    """Call ``fn(*args, on_stage=..., **kwargs)`` and stop it at its
    ``on_stage(stage)`` mark: the call's own code up to and including that
    stage, its work queued on the device. A call that never marks
    ``stage`` raises."""
    def mark(name):
        if name == stage:
            raise _Stop

    try:
        fn(*args, on_stage=mark, **kwargs)
    except _Stop:
        return
    raise ValueError(f"the call never reached the stage {stage!r}")


def timer_line(timer: str, device, **fields) -> dict:
    """Print one JSON line of an analysis timer: its name, the device, the
    card's name and power limit (nvidia-smi's; "none" on the CPU) and
    ``fields``; returns it."""
    from object_detectors_tpu_torch.bench import card_line

    line = {"timer": timer, "device": torch.device(device).type, "card": card_line(device),
            **fields}
    print(json.dumps(line), flush=True)
    return line


def trace(pipe, batches, calls, out_dir, filename="yolo_stages_trace.json"):
    """Device busy share and the kernels with the most device time over
    ``calls`` calls, from a torch.profiler trace (kept in ``out_dir``)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(calls):
            pipe(batches[i % len(batches)])
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(out_dir or tmp, filename)
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        return {"device_trace": "no kernel events in the trace"}
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:  # union of kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    window = spans[-1][1] - spans[0][0]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e["name"][:90]] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"trace_calls": calls, "kernel_launches": len(kernels),
            "device_busy_share": busy / window, "window_ms": window / 1e3,
            "top_kernels_ms_per_call": {k: v / 1e3 / calls for k, v in top}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("yolo_stages needs a GPU")

    pipe = build_pipeline_uint8(device="cuda")
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(0, 255, (BATCH, 640, 640, 3),
                                            dtype=np.uint8)).cuda() for _ in range(3)]
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        pipe.model(preprocess_images(batches[0][:1]))
    net_flops = fc.get_total_flops() * BATCH

    stages = stage_times(pipe, batches, ITERS)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    result = {
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True, check=True).stdout.strip(),
        "batch": BATCH, "stage_ms": stages, "stage_sum_ms": sum(stages.values()),
        "network_tflop": net_flops / 1e12,
        "network_bf16_peak_share": net_flops / (stages["network"] * 1e-3) / BF16_PEAK_FLOPS,
        **trace(pipe, batches, 3, args.out),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
