"""One rank of the port's data-parallel runs for tests/test_torch_data_parallel.py.

    python tests/torch_ddp_worker.py <job> <directory> <rank> <world>

The rank joins a gloo group through a ``file://`` rendezvous in
``directory`` (no TCP port), runs one torch thread, reads
``<directory>/<job>.in.pt`` (written by the test), runs the job on its
share of each global batch and writes ``<directory>/<job>.out<rank>.pt``.
A rank's share of a batch is rows rank, rank + world, ...: the places of its
images in the global batch, as ``data/coco.py:shard_indices`` deals them
out. Imports no JAX: the test holds what comes back against JAX.

Jobs:

* ``ops``: the global batch norm forward, backward and running statistics
  in float32 and bfloat16, and each loss normalizer of the port
  (``losses``): the rank's loss values and the gradients of their sum;
* ``yolo``: ``trainer.yolo_train_step`` of the tiny YOLO under DDP, one
  step in float32 and two in float64: the metrics averaged over the ranks
  and the parameters and running statistics after the steps;
* ``detection``: one ``trainer.detection_train_step`` of each
  ``detection_main`` architecture under DDP (the samplers' generator
  seeded as the CLI seeds it), and ``detection_main.evaluate`` of the tiny
  Faster R-CNN on a set that does not split evenly;
* ``pipeline``: ``main.train_pipeline`` of the tiny YOLO, two epochs
  straight and one epoch then a resume, recording each rank's checkpoint
  writes.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch

from object_detectors_tpu_torch.parallel import mesh


def rows(a, rank: int, world: int):
    """The rank's rows of a global batch (a tensor or array, batch first)."""
    return a[rank::world]


def tensors(d: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
            for k, v in d.items()}


# -- ops ---------------------------------------------------------------------

def batch_norm_case(inp: dict, dtype, rank: int, world: int) -> dict:
    from object_detectors_tpu_torch.parallel.batch_norm import global_batch_norm

    c = inp["x"].shape[1]
    bn = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["weight"]))
        bn.bias.copy_(torch.from_numpy(inp["bias"]))
        bn.running_mean.copy_(torch.from_numpy(inp["running_mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["running_var"]))
    x = rows(torch.from_numpy(inp["x"]), rank, world).to(dtype).requires_grad_()
    y = global_batch_norm(x, bn)
    y.backward(rows(torch.from_numpy(inp["dy"]), rank, world).to(dtype))
    return {"y": y.detach().float(), "dx": x.grad.float(), "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var, "y_dtype": str(y.dtype)}


def loss_fn(name: str):
    from object_detectors_tpu_torch.data import idf
    from object_detectors_tpu_torch.models import keypoint_rcnn, mask_rcnn, retinanet, roi_heads
    from object_detectors_tpu_torch.models import rpn, ssd, yolo_criterion

    return {"yolo_loss": yolo_criterion.yolo_loss, "rpn_loss": rpn.rpn_loss,
            "fastrcnn_loss": roi_heads.fastrcnn_loss, "maskrcnn_loss": mask_rcnn.maskrcnn_loss,
            "keypointrcnn_loss": keypoint_rcnn.keypointrcnn_loss, "ssd_loss": ssd.ssd_loss,
            "retinanet_loss": retinanet.retinanet_loss,
            "minibatch_idf": idf.minibatch_idf}[name]


def loss_case(case: dict, rank: int, world: int) -> dict:
    """``case``: the loss's name, its positional arguments (``args``, each
    ``("batch", array)`` sliced to the rank's rows, ``("pair", (a, b))``
    two such, or ``("shared", value)``), its keyword arguments and the
    indices of the arguments to differentiate (``grad``). Returns the
    rank's values by name (a loss dict's keys, else the outputs' places)
    and the gradients of their differentiable sum."""
    args = []
    for kind, v in case["args"]:
        if kind == "batch":
            args.append(rows(torch.from_numpy(v), rank, world).contiguous())
        elif kind == "pair":
            args.append(tuple(rows(torch.from_numpy(a), rank, world).contiguous() for a in v))
        else:
            args.append(torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
    for i in case["grad"]:
        args[i].requires_grad_()
    out = loss_fn(case["fn"])(*args, **tensors(case.get("kwargs", {})))
    values = dict(out) if isinstance(out, dict) else dict(
        enumerate(out if isinstance(out, tuple) else [out]))
    if case["grad"]:
        sum(v.sum() for v in values.values() if v.requires_grad).backward()
    return {"values": {str(k): v.detach() for k, v in values.items()},
            "grads": [args[i].grad for i in case["grad"]]}


def job_ops(inp: dict, rank: int, world: int) -> dict:
    return {"batch_norm": {str(dt): batch_norm_case(inp["batch_norm"], dt, rank, world)
                           for dt in (torch.float32, torch.bfloat16)},
            "losses": {name: loss_case(case, rank, world)
                       for name, case in inp["losses"].items()}}


# -- yolo --------------------------------------------------------------------

def job_yolo(inp: dict, rank: int, world: int) -> dict:
    from object_detectors_tpu_torch.models.yolo import YoloHead
    from object_detectors_tpu_torch.train import optim, trainer

    out = {}
    for name, run in inp["runs"].items():
        dtype = run["dtype"]
        model = YoloHead(4, 3, (1, 1, 1, 1, 1), dtype=dtype)
        model.load_state_dict(run["state_dict"])
        model = mesh.data_parallel(model.to(dtype))
        state = trainer.create_yolo_train_state(
            model, optim.make_optimizer(inp["optimizer"], inp["scheduler"]))
        metrics = []
        for batch in run["batches"]:
            x, boxes, labels, valid = (rows(torch.from_numpy(batch[k]), rank, world)
                                       for k in ("images", "gt_boxes", "gt_labels", "gt_valid"))
            state, m = trainer.yolo_train_step(state, x.to(dtype), boxes, labels, valid,
                                               inp["loss_cfg"], 4)
            metrics.append({k: mesh.all_reduce_mean(m[k]) for k in ("loss", "sub_losses",
                                                                      "stats")}
                           | {"grad_norm": m["grad_norm"],
                              "rank_loss": m["loss"]})
        out[name] = {"metrics": metrics,
                     "state_dict": {k: v.clone() for k, v in
                                    model.module.state_dict().items()}}
    return out


# -- detection -----------------------------------------------------------------

def eval_set(n: int = 7, seed: int = 1):
    """A renderable synthetic set of ``n`` 96² images (4 classes), as
    ``detection_main.synthetic_datasets`` builds its val set."""
    from object_detectors_tpu_torch.data import coco as data_coco
    from object_detectors_tpu_torch.data import synthetic

    gt = synthetic.make_coco_dicts(np.random.RandomState(seed), n, 96, 4)
    imgs = {im["id"]: synthetic.render_image(gt, im["id"]) for im in gt["images"]}
    return data_coco.CocoDetectionDataset(
        gt, label_mode="lvis0", image_loader=lambda info: imgs[info["id"]]), gt


def adapter(name: str, size: int):
    from object_detectors_tpu_torch import detection_main as DM

    return DM.ModelAdapter(name, 5 if "keypoint" not in name else 2, size,
                           resnet_layers=(1, 1, 1, 1), small=True, device="cpu")


def detection_step(name: str, size: int, batch: dict, seed: int, rank: int = 0,
                   world: int = 1) -> dict:
    """One step of a tiny ``ModelAdapter`` at ``size`` on the rank's rows of
    ``batch``, as ``detection_main.main`` takes it (SGD with warmup, the
    samplers' generator seeded from (seed, 0)). Returns the losses averaged
    over the ranks, the gradients of the step (averaged by DDP) and the
    model's state after it."""
    from object_detectors_tpu_torch.train import optim, trainer
    from object_detectors_tpu_torch.train.checkpoint import unwrapped

    ad = adapter(name, size)
    ad.model = mesh.data_parallel(ad.model)
    tx = optim.make_optimizer(optim.OptimizerConfig("sgd", 0.0025, 1e-4, 0.9),
                              optim.SchedulerConfig())
    state = trainer.create_detection_train_state(ad, tx)
    local = {k: rows(torch.from_numpy(v), rank, world).contiguous() for k, v in batch.items()}
    _, total, losses = trainer.detection_train_step(
        state, ad, local, generator=trainer.draw_generator(seed, 0))
    out = {"losses": {k: mesh.all_reduce_mean(v) for k, v in losses.items()},
            "total": mesh.all_reduce_mean(total),
            "grads": {k: p.grad.clone() for k, p in unwrapped(ad.model).named_parameters()
                      if p.grad is not None},
            "state_dict": {k: v.clone() for k, v in unwrapped(ad.model).state_dict().items()}}
    # a second step: DDP raises in its forward if a parameter took no
    # gradient in the first
    trainer.detection_train_step(state, ad, local, generator=trainer.draw_generator(seed, 1))
    return out


def sharded_eval(batch_size: int) -> dict:
    """``detection_main.evaluate`` of the seeded tiny Faster R-CNN at 64 px
    on ``eval_set()``: the merged results and the bbox mAP."""
    from object_detectors_tpu_torch import detection_main as DM

    ds, gt = eval_set()
    mAP, ev, _ = DM.evaluate(adapter("fasterrcnn_resnet50_fpn", 64), ds, gt, batch_size,
                             max_boxes=8, min_size=64, max_size=128)
    return {"mAP": mAP, "results": ev.results}


def job_detection(inp: dict, rank: int, world: int) -> dict:
    steps = {name: detection_step(name, case["size"], case["batch"], inp["seed"], rank, world)
             for name, case in inp["steps"].items()}
    return {"steps": steps, "eval": sharded_eval(inp["eval_batch_size"])}


# -- pipeline ------------------------------------------------------------------

class _NoTensorBoard:
    """The progress writer without TensorBoard: importing it pulls in
    TensorFlow, about 15 s in each rank; the writes are rank 0's either way."""

    def __init__(self, logdir):
        pass

    def scalar(self, tag, value, step):
        pass

    def close(self):
        pass


def job_pipeline(inp: dict, rank: int, world: int) -> dict:
    from object_detectors_tpu_torch import main as M
    from object_detectors_tpu_torch.train import checkpoint as ckpt_lib
    from object_detectors_tpu_torch.utils import logging as log_lib

    log_lib.TensorBoardWriter = _NoTensorBoard
    writes = []
    save_raw = ckpt_lib.CheckpointManager.save_raw

    def spy(self, tag, payload, epoch, metrics):
        writes.append((os.path.basename(self.directory), tag, epoch))
        return save_raw(self, tag, payload, epoch, metrics)

    ckpt_lib.CheckpointManager.save_raw = spy
    seen = {}
    for run, overrides in inp["runs"]:
        cfg = M.load_config(M.CONFIG_DIR, overrides)
        state, best = M.train_pipeline(cfg)
        seen[run] = {"step": state.step, "best": best}
        torch.distributed.barrier()  # every rank done before the next run reads
    return {"writes": writes, "runs": seen}


JOBS = {"ops": job_ops, "yolo": job_yolo, "detection": job_detection,
        "pipeline": job_pipeline}


def main(argv) -> int:
    job, directory, rank, world = argv[0], argv[1], int(argv[2]), int(argv[3])
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(directory, 'rendezvous')}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        inp = torch.load(os.path.join(directory, f"{job}.in.pt"), weights_only=False)
        out = JOBS[job](inp, rank, world)
        torch.save(out, os.path.join(directory, f"{job}.out{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
