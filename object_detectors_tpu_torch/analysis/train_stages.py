"""Where the time of the two training cells goes on one GPU.

    python -m object_detectors_tpu_torch.analysis.train_stages [--out DIR]

* yolo_train416: the port bench's row, Darknet-53 YOLOv3 (80 classes,
  416², bf16 activations, f32 parameters, seeded random weights), batch 128,
  SGD at 1e-3 with momentum 0.9;
* frcnn_train800: Faster R-CNN R50-FPN (91 classes, 800², f32), batch 2,
  RPN 2000/2000, 512 RoIs an image, SGD at 0.0025 with momentum 0.9, weight
  decay 1e-4 and the linear warmup of ``detection_main``.

For each: device time of the forward with the loss and of the backward with
the optimizer update (CUDA events around each; mean of ITERS steps after two
warm-up steps), and a torch.profiler trace of three steps: the device's busy
share of the window and the kernels that take the most device time. Prints
one JSON line per cell; the Chrome traces go to ``DIR`` when ``--out`` is
given. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from object_detectors_tpu_torch.analysis.yolo_stages import trace
from object_detectors_tpu_torch.bench import yolo_train_setup
from object_detectors_tpu_torch.models import faster_rcnn as F
from object_detectors_tpu_torch.train import optim, trainer

ITERS = 5
YOLO_BATCH = 128
FRCNN_BATCH, FRCNN_IMG, FRCNN_CLASSES = 2, 800, 91


def frcnn_train_batch(seed: int, batch: int = FRCNN_BATCH, size: int = FRCNN_IMG,
                      slots: int = 20, device="cuda"):
    """Seeded float images (standard normal: normalized pixels) and GT:
    ``slots`` boxes an image (xyxy, sides 16 to 316 px), 70 % valid,
    labels 1..90: [images, gt_boxes, gt_labels, gt_valid] on ``device``."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(batch, slots, 2) * (size - 120)
    wh = 16 + rng.rand(batch, slots, 2) * 300
    boxes = np.concatenate([xy, np.minimum(xy + wh, size)], -1).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (
        rng.randn(batch, size, size, 3).astype(np.float32), boxes,
        rng.randint(1, FRCNN_CLASSES, (batch, slots)), rng.rand(batch, slots) < 0.7)]


def frcnn_train_setup(device="cuda", steps_per_epoch: int = 1000):
    """(state, the three batches) of frcnn_train800: the full-width model
    with seeded random weights and detection_main's optimizer: SGD at
    0.0025, momentum 0.9, weight decay 1e-4, the multistep decay at epochs
    16 and 22 and a linear warmup over min(1000, steps_per_epoch) steps
    from 1/1000."""
    model = F.init_frcnn_(F.FasterRCNN(F.FasterRCNNConfig(num_classes=FRCNN_CLASSES)),
                          seed=0).to(device)
    tx = optim.make_optimizer(optim.OptimizerConfig("sgd", 0.0025, 1e-4, 0.9),
                              optim.SchedulerConfig("multistep", milestones=(16, 22),
                                                    warmup_steps=min(1000, steps_per_epoch),
                                                    warmup_factor=1.0 / 1000),
                              steps_per_epoch)
    return (trainer.create_frcnn_train_state(model, tx),
            [frcnn_train_batch(seed, device=device) for seed in range(3)])


def step_stage_times(forward_loss, state, batches, iters=ITERS):
    """Device ms of the forward with the loss and of the backward with the
    update, mean of ``iters`` steps after two warm-up steps."""
    totals = {"forward+loss": 0.0, "backward+update": 0.0}
    for i in range(iters + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss = forward_loss(batches[i % len(batches)])
        ev[1].record()
        trainer.backward_and_update(state, loss)
        ev[2].record()
        torch.cuda.synchronize()
        if i >= 2:
            totals["forward+loss"] += ev[0].elapsed_time(ev[1])
            totals["backward+update"] += ev[1].elapsed_time(ev[2])
    return {k: v / iters for k, v in totals.items()}


def cell(name, forward_loss, state, batches, out_dir):
    stages = step_stage_times(forward_loss, state, batches)

    def step(b):
        trainer.backward_and_update(state, forward_loss(b))
        return None, torch.zeros(1)

    return {"cell": name, "stage_ms": stages, "step_ms": sum(stages.values()),
            **trace(step, batches, 3, out_dir, f"{name}_trace.json")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="directory for the Chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_stages needs a GPU")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    tf32 = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}

    state, cfg, batches = yolo_train_setup(YOLO_BATCH)
    print(json.dumps({"card": card, "tf32": tf32, "batch": YOLO_BATCH, **cell(
        "yolo_train416", lambda b: trainer.yolo_forward_loss(
            state, b["images"], b["gt_boxes"], b["gt_labels"], b["gt_valid"], cfg,
            cfg.num_classes)[0], state, batches, args.out)}), flush=True)
    del state, batches

    state, batches = frcnn_train_setup()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps({"card": card, "tf32": tf32, "batch": FRCNN_BATCH, **cell(
        "frcnn_train800", lambda b: trainer.frcnn_forward_loss(state, *b, generator=gen)[0],
        state, batches, args.out)}), flush=True)


if __name__ == "__main__":
    main()
