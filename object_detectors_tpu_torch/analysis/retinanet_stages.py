"""Where the time of the RetinaNet R50-FPN path goes on one GPU.

    python -m object_detectors_tpu_torch.analysis.retinanet_stages [--out DIR]

Full-width RetinaNet (ResNet-50-FPN P3-P7, 9 anchors, 91 classes, 640²,
bf16, seeded random weights) through the uint8 pipeline at batch 16 on three
distinct pre-staged batches, once with the backbone unfused
(``backbone_fused="off"``) and once with the fused bottleneck kernel
(``"auto"``), on the same weights:

* per-stage device time with CUDA events at the pipeline's stage marks
  (normalize, backbone+FPN, head, select, cap+decode, NMS), mean of 10 calls
  after one warm-up (``frcnn_stages.stage_times``); the whole call's rate is
  chip_smoke.py's retinanet_e2e phase;
* a torch.profiler trace of a few calls: device busy share of the window and
  the kernels that take the most device time;
* the convolutions' FLOPs (torch.utils.flop_counter, the unfused path) and
  their share of the bf16 tensor-core peak over the backbone+FPN and head
  stages.

Prints one JSON line; the Chrome traces go to
``DIR/retinanet_stages_{off,auto}_trace.json`` when ``--out`` is given. Needs
a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from object_detectors_tpu_torch.analysis.frcnn_stages import stage_times
from object_detectors_tpu_torch.analysis.yolo_stages import BF16_PEAK_FLOPS, trace
from object_detectors_tpu_torch.models.resnet import set_fused
from object_detectors_tpu_torch.pipeline import build_retinanet_pipeline_uint8

BATCH, ITERS = 16, 10
DENSE_STAGES = ("backbone+FPN", "head")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="directory for the Chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("retinanet_stages needs a GPU")

    pipe = build_retinanet_pipeline_uint8(device="cuda")
    rng = np.random.RandomState(1)
    batches = [torch.from_numpy(rng.randint(0, 255, (BATCH, 640, 640, 3),
                                            dtype=np.uint8)).cuda() for _ in range(3)]
    with FlopCounterMode(display=False) as fc:
        pipe(batches[0])
    flops = fc.get_total_flops()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    result = {
        "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True, check=True).stdout.strip(),
        "batch": BATCH, "dense_tflop": flops / 1e12,
    }
    for mode in ("off", "auto"):
        set_fused(pipe.model, mode)
        stages = stage_times(pipe, batches, ITERS)
        dense_ms = sum(stages[s] for s in DENSE_STAGES)
        result[mode] = {
            "stage_ms": stages, "stage_sum_ms": sum(stages.values()),
            "dense_bf16_peak_share": flops / (dense_ms * 1e-3) / BF16_PEAK_FLOPS,
            **trace(pipe, batches, 3, args.out, f"retinanet_stages_{mode}_trace.json"),
        }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
