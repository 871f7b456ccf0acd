"""YOLO training-step stage budget on one GPU (port of the JAX package's
``analysis/train_ablate.py``).

    python -m object_detectors_tpu_torch.analysis.train_ablate [--bs 16]
        [--size 416] [--iters 12] [--device cpu]

Cumulative prefixes of the YOLOv3 train step (Darknet-53, 80 classes, bf16
activations, f32 parameters, seeded weights; the optimizer of
``optim.make_optimizer(OptimizerConfig(), SchedulerConfig(), 100)``) on
one seeded batch (``make_batch``, the JAX timer's draw):

* ``fwd_eval``: the forward in eval mode;
* ``fwd_train``: the forward in train mode (batch statistics);
* ``fwd_loss``: + ``yolo_loss`` (``trainer.yolo_forward_loss``);
* ``grad``: + the backward, no update;
* ``full``: the whole step, ``trainer.yolo_train_step`` (+ the SGD update);
* ``full_ingest``: ``trainer.yolo_train_step_ingest`` from a seeded uint8
  canvas (images of 320² to the canvas's 640² placed top-left): the bicubic
  resize and normalize on the device, then the step.

A train-mode forward moves the batch-norm running statistics (toward the
biased batch variance, as Flax's), where JAX's ``mutable=["batch_stats"]``
returns them without applying them; so each stage runs on its own deep
copy of the model, and the model the copies come from must be bitwise
unchanged after the timing (a difference raises). Each stage is timed with
back-to-back calls and one synchronization at the end
(``yolo_stages.time_calls``). No kernel of the port is on this path: the
ingest resizes are plain PyTorch, as JAX's are XLA. Prints one JSON line:
the card's name and power limit, each stage's ms, its marginal over the
stage before, its images/s and each stage's last loss.

The JAX timer has no TPU-only variant; all its rows are ported, and
``full_ingest`` is the device-ingest step its docstring names.
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.yolo_stages import prefix_times, timer_line
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
from object_detectors_tpu_torch.train import optim, trainer

NUM_CLASSES, SLOTS, CANVAS = 80, 32, 640


def make_batch(bs: int, size: int, rng: np.random.RandomState, device="cuda") -> dict:
    """Seeded images [bs, size, size, 3] bf16 in [0, 1) and 32 GT slots:
    boxes from sorted pairs in [0, 1), labels below 80, half valid."""
    return dict(
        images=torch.from_numpy(rng.rand(bs, size, size, 3).astype(np.float32)).to(
            device, torch.bfloat16),
        gt_boxes=torch.from_numpy(np.sort(rng.rand(bs, SLOTS, 2, 2), axis=2)
                                  .reshape(bs, SLOTS, 4).astype(np.float32)).to(device),
        gt_labels=torch.from_numpy(rng.randint(0, NUM_CLASSES, (bs, SLOTS))).to(device),
        gt_valid=torch.from_numpy(rng.rand(bs, SLOTS) < 0.5).to(device))


def make_canvas(bs: int, rng: np.random.RandomState, device="cuda"):
    """A seeded uint8 canvas [bs, 640, 640, 3] and each image's (h, w),
    sides 320 to 640."""
    return (torch.from_numpy(rng.randint(0, 255, (bs, CANVAS, CANVAS, 3), dtype=np.uint8)
                             ).to(device),
            torch.from_numpy(rng.randint(CANVAS // 2, CANVAS + 1, (bs, 2))).to(device))


def build_stages(model, batch: dict, canvas, sizes, cfg: YC.YoloLossConfig):
    """{name: fn() -> output}: the module docstring's stages, each on its
    own deep copy of ``model`` and, for the loss stages, its own train
    state."""
    tx = optim.make_optimizer(optim.OptimizerConfig(), optim.SchedulerConfig(), 100)
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])

    def state():
        return trainer.create_yolo_train_state(copy.deepcopy(model), tx)

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    s_eval, s_train, s_loss, s_grad, s_full, s_ingest = (state() for _ in range(6))
    s_eval.model.eval()

    def grad():
        s_grad.model.zero_grad(set_to_none=True)
        loss = trainer.yolo_forward_loss(s_grad, batch["images"], *gt, cfg, NUM_CLASSES)[0]
        loss.backward()
        return loss.detach()

    return {
        "fwd_eval": no_grad(lambda: s_eval.model(batch["images"], train=False)),
        "fwd_train": no_grad(lambda: s_train.model(batch["images"], train=True)),
        "fwd_loss": no_grad(lambda: trainer.yolo_forward_loss(
            s_loss, batch["images"], *gt, cfg, NUM_CLASSES)[0]),
        "grad": grad,
        "full": lambda: trainer.yolo_train_step(s_full, batch["images"], *gt, cfg,
                                                NUM_CLASSES)[1]["loss"],
        "full_ingest": lambda: trainer.yolo_train_step_ingest(
            s_ingest, canvas, sizes, *gt, cfg, NUM_CLASSES)[1]["loss"],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = YC.YoloLossConfig(num_classes=NUM_CLASSES, img_size=args.size)
    model = init_yolo_(YoloHead(NUM_CLASSES, dtype=torch.bfloat16), seed=0).to(dev)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    batch = make_batch(args.bs, args.size, rng, dev)
    canvas, sizes = make_canvas(args.bs, rng, dev)
    stages = build_stages(model, batch, canvas, sizes, cfg)
    ms, marginal = prefix_times(stages, iters=args.iters, device=dev)
    losses = {name: float(stages[name]()) for name in ("fwd_loss", "grad", "full",
                                                       "full_ingest")}
    unchanged = all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    if not unchanged or not all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"train_ablate: model unchanged {unchanged}, losses {losses}")
    return timer_line("train_ablate", dev, bs=args.bs, size=args.size, dtype="bfloat16",
                      iters=args.iters, stage_ms=ms, marginal_ms=marginal,
                      img_per_s={k: args.bs / v * 1e3 for k, v in ms.items()},
                      last_loss=losses, model_unchanged=unchanged)


if __name__ == "__main__":
    main()
