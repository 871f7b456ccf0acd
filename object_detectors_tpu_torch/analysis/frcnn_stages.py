"""Where the time of the Faster R-CNN R50-FPN path goes on one GPU.

    python -m object_detectors_tpu_torch.analysis.frcnn_stages [--out DIR]

Full-width Faster R-CNN (ResNet-50-FPN, 91 classes, 640², bf16, seeded
random weights) through the uint8 pipeline at batch 16 on three distinct
pre-staged batches:

* per-stage device time with CUDA events at the pipeline's stage marks
  (normalize, backbone+FPN, RPN head, proposal filter, pooler, box head,
  postprocess), mean of 10 calls after one warm-up; the whole call's rate
  is chip_smoke.py's frcnn_e2e phase;
* a torch.profiler trace of a few calls: device busy share of the window and
  the kernels that take the most device time;
* the convolutions' and matrix products' FLOPs (torch.utils.flop_counter)
  and their share of the bf16 tensor-core peak over the stages that run them.

Prints one JSON line; the Chrome trace goes to ``DIR/frcnn_stages_trace.json``
when ``--out`` is given. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from object_detectors_tpu_torch.analysis.yolo_stages import BF16_PEAK_FLOPS, trace
from object_detectors_tpu_torch.pipeline import build_frcnn_pipeline_uint8

BATCH, ITERS = 16, 10
DENSE_STAGES = ("backbone+FPN", "RPN head", "box head")


def stage_times(pipe, batches, iters: int):
    """Mean device time of each stage (CUDA events at the pipeline's stage
    marks) over ``iters`` calls after one warm-up."""
    totals = {}
    for i in range(iters + 1):
        events = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        start = torch.cuda.Event(enable_timing=True)
        start.record()
        pipe(batches[i % len(batches)], on_stage=mark)
        torch.cuda.synchronize()
        prev = start
        for name, ev in events:
            if i:  # the first round warms up
                totals[name] = totals.get(name, 0.0) + prev.elapsed_time(ev)
            prev = ev
    return {name: t / iters for name, t in totals.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("frcnn_stages needs a GPU")

    pipe = build_frcnn_pipeline_uint8(device="cuda")
    rng = np.random.RandomState(2)
    batches = [torch.from_numpy(rng.randint(0, 255, (BATCH, 640, 640, 3),
                                            dtype=np.uint8)).cuda() for _ in range(3)]
    with FlopCounterMode(display=False) as fc:
        pipe(batches[0])
    flops = fc.get_total_flops()

    stages = stage_times(pipe, batches, ITERS)
    dense_ms = sum(stages[s] for s in DENSE_STAGES)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    result = {
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True, check=True).stdout.strip(),
        "batch": BATCH, "stage_ms": stages, "stage_sum_ms": sum(stages.values()),
        "dense_tflop": flops / 1e12,
        "dense_bf16_peak_share": flops / (dense_ms * 1e-3) / BF16_PEAK_FLOPS,
        **trace(pipe, batches, 3, args.out, "frcnn_stages_trace.json"),
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
