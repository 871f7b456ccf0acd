"""Training / evaluation pipeline and CLI of the YOLO family (port of the
JAX package's ``main.py``, the reference's ``yolo/main.py``).

One process a card; above one process (``torchrun``) the model is wrapped
in DDP, its batch norms and loss normalizers count the global batch, and
the logged metrics are averaged over the processes (``parallel/mesh.py``);
rank 0 writes the logs and checkpoints; schedulers and the evaluation
merge run on the host.

Subcommands:
* ``train``    — epoch loop with mAP-or-val_loss model selection,
                 best/last checkpoints, multiscale, progress CSV + TB.
* ``evaluate`` — COCO-protocol evaluation of a checkpoint, with an
                 optional detections JSON dump.

Runs on the card unless the overrides ask for the CPU (``device=cpu``).

Usage: python -m object_detectors_tpu_torch.main train [group=name a.b=v ...]
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.data import coco as data_coco
from object_detectors_tpu_torch.data import idf as idf_lib
from object_detectors_tpu_torch.data import synthetic
from object_detectors_tpu_torch.eval import evaluator as eval_lib
from object_detectors_tpu_torch.kernels.preprocess import resize_normalize_from_canvas
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
from object_detectors_tpu_torch.ops.losses import effective_number_weights
from object_detectors_tpu_torch.ops.nms import nms_majority
from object_detectors_tpu_torch.ops.selection import radix_topk
from object_detectors_tpu_torch.parallel import mesh
from object_detectors_tpu_torch.train import checkpoint as ckpt_lib
from object_detectors_tpu_torch.train import optim as optim_lib
from object_detectors_tpu_torch.train import trainer
from object_detectors_tpu_torch.utils import logging as log_lib
from object_detectors_tpu_torch.utils.config import CONFIG_DIR, Config, load_config

log = logging.getLogger("object_detectors_tpu_torch")


# --------------------------------------------------------------------- #
# Configuration -> loss, model, tf-idf weights, datasets
# --------------------------------------------------------------------- #

def build_loss_config(cfg: Config) -> YC.YoloLossConfig:
    y = cfg.yolo
    return YC.YoloLossConfig(
        num_classes=int(y.classes),
        img_size=int(y.img_size),
        anchors=tuple(tuple(tuple(a) for a in scale) for scale in cfg.dataset.anchors),
        ignore_threshold=float(y.ignore_threshold),
        iou_type=int(y.iou_type),
        lambda_iou=float(y.lambda_iou),
        lambda_xy=float(y.lambda_xy),
        lambda_wh=float(y.lambda_wh),
        lambda_conf=float(y.lambda_conf),
        lambda_no_conf=float(y.lambda_no_conf),
        lambda_cls=float(y.lambda_cls),
        alpha=float(y.alpha),
        gamma=float(y.gamma),
        class_loss=int(y.class_loss),
        reduction=str(y.reduction),
        tfidf_batch=bool(y.get("tfidf_batch", False)),
        tfidf_norm=int(y.get("tfidf_norm", 0)),
    )


def build_model(cfg: Config) -> YoloHead:
    """The configured YOLO with seeded random weights (``seed``);
    ``precision`` bf16 runs the activations in bfloat16, parameters stay
    float32."""
    dtype = torch.bfloat16 if cfg.get_path("precision", "bf16") == "bf16" else torch.float32
    model = YoloHead(
        num_classes=int(cfg.yolo.classes),
        anchors_per_scale=len(cfg.dataset.anchors[0]),
        backbone_layers=tuple(cfg.backbone.layers),
        use_spp=bool(cfg.neck.spp),
        use_fpn=bool(cfg.neck.fpn),
        pyramids=tuple(tuple(p) for p in cfg.neck.pyramids),
        dtype=dtype,
    )
    return init_yolo_(model, int(cfg.get_path("seed", 0)))


def _padded(vec, n: int) -> np.ndarray:
    """``vec`` padded with ones / truncated to ``n`` classes (classes with no
    annotations drop out of the idf tables)."""
    out = np.ones(n, np.float32)
    vec = np.asarray(vec, np.float32)
    out[: min(len(vec), n)] = vec[:n]
    return out


def build_tfidf(cfg: Config, gt_train: dict | None, device="cpu"):
    """yolo_forw.py:50-77 wiring: (class_weights, idf_logits, eq_rare_mask)
    as float32 tensors on ``device``, or None / 1.0 / None."""
    y = cfg.yolo
    num_classes = int(y.classes)
    weights, idf_logits, rare = None, 1.0, None
    tfidf = list(y.tfidf)
    if (tfidf[0] or tfidf[1] or int(y.class_loss) == 2) and gt_train:
        tables = idf_lib.idf_tables(gt_train)
        full = _padded(tables[str(y.get("tfidf_variant", "smooth"))], num_classes)
        norm_p = int(y.get("tfidf_norm", 0))

        def normed(v):
            return v / np.linalg.norm(v, ord=norm_p) if norm_p else v

        def tensor(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)
        if tfidf[0] == 1:
            weights = tensor(normed(full.copy()))
        elif tfidf[0] == 2:
            weights = effective_number_weights(
                _padded(tables["instance_freq"], num_classes)).to(device)
        if tfidf[1] == 1:
            idf_logits = tensor(normed(full.copy()))
        if int(y.class_loss) == 2:
            rare = tensor(idf_lib.eq_rare_mask(_padded(tables["img_freq"], num_classes)))
    return weights, idf_logits, rare


def build_dataset(cfg: Config, split: str):
    """Returns (dataset, gt_dict)."""
    d = cfg.dataset
    if d.dset_name == "synthetic":
        rng = np.random.RandomState(0 if split == "train" else 1)
        gt, loader = synthetic.renderable_dataset(
            rng, num_images=int(d.get("num_images", 16)), img_size=96,
            num_classes=int(d.num_classes))
        return data_coco.CocoDetectionDataset(gt, label_mode="lvis0", image_loader=loader), gt
    ann = d.train_annotations if split == "train" else d.val_annotations
    imgs_dir = d.get("train_images" if split == "train" else "val_images")
    label_mode = {"coco": "coco80", "lvis": "lvis0"}.get(d.dset_name, "raw")
    ds = data_coco.CocoDetectionDataset(
        ann, imgs_dir, label_mode,
        subset=float(d.tr_subset if split == "train" else d.ts_subset))
    return ds, ds.gt


def label_map_for(cfg: Config):
    if cfg.dataset.dset_name == "coco":
        return lambda c: eval_lib.COCO_80_TO_91[c]
    return lambda c: c + 1  # lvis0/synthetic: contiguous -> 1-based ids


def _device_of(state) -> torch.device:
    return next(state.model.parameters()).device


def _to(batch: dict, keys, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device) for k in keys}


# --------------------------------------------------------------------- #
# Epoch procedures (procedures/{train,valid,test}_one_epoch.py parity)
# --------------------------------------------------------------------- #

def train_one_epoch(state, cfg, loss_cfg, dataset, epoch, class_weights, idf_logits,
                    writer=None, ckpt=None):
    """One epoch of training; returns (state, mean sub-losses, mean stats),
    or (state, None, None) when a loss is not finite."""
    num_classes = loss_cfg.num_classes
    anchors_per_scale = len(loss_cfg.anchors[0])
    dev = _device_of(state)
    logger = log_lib.MetricLogger()
    ms = cfg.multiscaler
    sizes = (trainer.multiscale_sizes(loss_cfg.img_size, *tuple(ms.bounds))
             if ms.multi_scale else (loss_cfg.img_size,))
    cur_size = loss_cfg.img_size
    sub_sum = np.zeros(6)
    stat_sum = np.zeros(5)
    n_iters = 0
    batch_size = mesh.per_process_batch(int(cfg.dataset.tr_batch_size))

    # config-gated train augmentation (init_dataset.py:31)
    augment_rng = None
    if int(cfg.dataset.get("augment", 0) or 0) > 0:
        augment_rng = np.random.RandomState(int(cfg.seed) * 977 + epoch + mesh.process_index())
    # device ingest (default on): the host only decodes; the bicubic resize
    # and normalize run on the device inside the step
    ingest = bool(cfg.dataset.get("device_ingest_train", True))
    common = dict(max_boxes=int(cfg.dataset.get("max_boxes", 100)), shuffle=True,
                  seed=int(cfg.seed) + epoch, augment_rng=augment_rng,
                  process_index=mesh.process_index(), process_count=mesh.process_count())
    if ingest:
        batches = data_coco.yolo_batches_uint8(
            dataset, batch_size, loss_cfg.img_size,
            canvas_size=int(cfg.dataset.get("canvas_size", 640)), **common)
    else:
        batches = data_coco.yolo_batches(dataset, batch_size, loss_cfg.img_size, **common)
    gt_keys = ("gt_boxes", "gt_labels", "gt_valid")
    autosave = int(cfg.get_path("autosave_steps", 0) or 0)
    for i, batch in enumerate(logger.log_every(batches, int(cfg.verbose_freq),
                                               f"epoch {epoch}", printer=log.info)):
        if ms.multi_scale and i % int(ms.freq) == 0:
            # every process derives the same size from (seed, epoch, i)
            cur_size = trainer.pick_scale(trainer.draw_generator(int(cfg.seed), epoch * 100003 + i),
                                          sizes)
        scaled_cfg = (loss_cfg if cur_size == loss_cfg.img_size else
                      YC.YoloLossConfig(**{**loss_cfg.__dict__, "img_size": int(cur_size)}))
        if ingest:
            t = _to(batch, ("images", "sizes") + gt_keys, dev)
            state, metrics = trainer.yolo_train_step_ingest(
                state, t["images"], t["sizes"], t["gt_boxes"], t["gt_labels"], t["gt_valid"],
                scaled_cfg, num_classes, anchors_per_scale=anchors_per_scale,
                class_weights=class_weights, idf_logits=idf_logits)
        else:
            t = _to(batch, ("images",) + gt_keys, dev)
            images = t["images"]
            if cur_size != images.shape[1]:
                images = F.interpolate(images.permute(0, 3, 1, 2), size=(cur_size, cur_size),
                                       mode="bilinear", align_corners=False,
                                       antialias=True).permute(0, 2, 3, 1)
            state, metrics = trainer.yolo_train_step(
                state, images, t["gt_boxes"], t["gt_labels"], t["gt_valid"], scaled_cfg,
                num_classes, anchors_per_scale, class_weights=class_weights,
                idf_logits=idf_logits)
        loss = float(mesh.all_reduce_mean(metrics["loss"]))
        if not np.isfinite(loss):
            log.warning("non-finite loss at epoch %d iter %d", epoch, i)
            return state, None, None  # the reference aborts (ZeroDiv -> None)
        sub_sum += mesh.all_reduce_mean(metrics["sub_losses"]).double().cpu().numpy()
        stat_sum += mesh.all_reduce_mean(metrics["stats"]).double().cpu().numpy()
        n_iters += 1
        opt = state.optimizer
        logger.update(loss=loss, lr=opt.schedule(opt.count - 1) * opt.plateau_scale)
        if writer is not None and bool(cfg.track_epoch):
            writer.scalar("iter/loss", loss, epoch * 10_000 + i)
        # preemption-safe mid-epoch autosave (SURVEY.md §5.3)
        if (ckpt is not None and autosave and n_iters % autosave == 0
                and mesh.process_index() == 0):
            ckpt.save("autosave", state, epoch, {"metric": float("nan")})
    n = max(n_iters, 1)
    return state, sub_sum / n, stat_sum / n


@torch.no_grad()
def valid_one_epoch(state, cfg, loss_cfg, dataset):
    """Loss-only validation (valid_one_epoch.py:7-35): the model in eval
    mode, ``yolo_loss`` without class weights or idf scaling."""
    dev = _device_of(state)
    total, n = 0.0, 0
    for batch in data_coco.yolo_batches(
            dataset, int(cfg.dataset.ts_batch_size), loss_cfg.img_size,
            int(cfg.dataset.get("max_boxes", 100)), process_index=mesh.process_index(),
            process_count=mesh.process_count()):
        t = _to(batch, ("images", "gt_boxes", "gt_labels", "gt_valid"), dev)
        outs = state.model(t["images"], train=False)
        raw = YC.flatten_raw_outputs(outs, loss_cfg.num_classes,
                                     len(loss_cfg.anchors[0])).float()
        priors, gw = YC.make_priors(loss_cfg, tuple(o.shape[1] for o in outs), dev)
        loss, _, _ = YC.yolo_loss(raw, priors, gw, t["gt_boxes"], t["gt_labels"],
                                  t["gt_valid"], loss_cfg)
        total += float(mesh.all_reduce_mean(loss))  # the global batch's loss
        n += 1
    return total / max(n, 1)


def decode_and_nms(state, cfg, loss_cfg, images, sizes=None, max_candidates=512,
                   idf_logits=1.0):
    """One eval batch (test_one_epoch.py): with ``sizes`` the uint8 canvas
    is bicubic-resized and normalized on its device first; then the decode
    with the idf logit scale, score = objectness x best class probability,
    the exact top-``max_candidates`` (``radix_topk``), xyxy boxes, the
    confidence mask and majority-vote NMS (the NMS kernel on the card).
    Returns (boxes [B, 100, 4], scores, labels, valid)."""
    num_classes = loss_cfg.num_classes
    if sizes is not None:
        images = resize_normalize_from_canvas(images, sizes, loss_cfg.img_size, torch.float32)
    dec = trainer.yolo_eval_step(state, images, loss_cfg, num_classes,
                                 len(loss_cfg.anchors[0]), idf_logits=idf_logits)
    cls_prob, cls = dec[..., 5:].max(-1)
    score = dec[..., 4] * cls_prob
    topv, topi = radix_topk(score, min(max_candidates, dec.shape[1]))
    xy, wh = dec[..., :2], dec[..., 2:4]
    xyxy = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    boxes = torch.gather(xyxy, 1, topi[..., None].expand(-1, -1, 4))
    labels = torch.gather(cls, 1, topi)
    return nms_majority(boxes, topv, labels, num_classes=num_classes,
                        iou_threshold=float(cfg.yolo.inf_iou_threshold), max_output=100,
                        valid=topv > float(cfg.yolo.inf_confidence))


@torch.no_grad()
def test_one_epoch(state, cfg, loss_cfg, dataset, gt, max_candidates=512, idf_logits=1.0):
    """Detection epoch + COCO eval (test_one_epoch.py + eval_results.py):
    ``decode_and_nms`` a batch, rescale, evaluate. Returns (mAP, evaluator)."""
    dev = _device_of(state)
    device_pre = bool(cfg.dataset.get("device_preprocess", False))
    ev = eval_lib.DetectionEvaluator(gt, label_map_for(cfg))
    common = dict(max_boxes=int(cfg.dataset.get("max_boxes", 100)),
                  process_index=mesh.process_index(), process_count=mesh.process_count())
    bs = int(cfg.dataset.ts_batch_size)
    if device_pre:
        batches = data_coco.yolo_batches_uint8(
            dataset, bs, loss_cfg.img_size,
            canvas_size=int(cfg.dataset.get("canvas_size", 640)), **common)
    else:
        batches = data_coco.yolo_batches(dataset, bs, loss_cfg.img_size, **common)
    for batch in batches:
        t = _to(batch, ("images", "sizes") if device_pre else ("images",), dev)
        out = decode_and_nms(state, cfg, loss_cfg, t["images"], t.get("sizes"),
                             max_candidates, idf_logits)
        keep = batch["image_ids"] >= 0
        ev.update(batch["image_ids"][keep], *(o[torch.from_numpy(keep).to(dev)] for o in out),
                  batch["scale_factors"][keep])
    ev.synchronize_between_processes()
    stats = ev.summarize()
    return float(stats[0]), ev


# --------------------------------------------------------------------- #
# Pipelines
# --------------------------------------------------------------------- #

def _optimizer(cfg: Config, steps_per_epoch: int):
    """The configured optimizer and schedule (``init(params)``)."""
    s = cfg.scheduler
    sched = optim_lib.SchedulerConfig(
        name=str(s.name), step_size=int(s.get("step_size", 100)),
        factor=float(s.get("factor", 0.1)),
        milestones=tuple(s.get("milestones", (15, 25))),
        base_lr=float(s.get("base_lr", 1e-4)), max_lr=float(s.get("max_lr", 1e-3)),
        mode=str(s.get("mode", "max")), patience=int(s.get("patience", 10)))
    return optim_lib.make_optimizer(
        optim_lib.OptimizerConfig(
            name=str(cfg.optimizer.name), lr=float(cfg.optimizer.lr),
            weight_decay=float(cfg.optimizer.weight_decay),
            momentum=float(cfg.optimizer.get("momentum", 0.9))),
        sched, steps_per_epoch)


def _profiler(out_dir: str, device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(os.path.join(out_dir, "profile")))


def train_pipeline(cfg: Config):
    out_dir = str(cfg.get_path("output_dir", "output/default"))
    os.makedirs(out_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        handlers=[logging.FileHandler(os.path.join(out_dir, "main.log")),
                  logging.StreamHandler(sys.stderr)])

    mesh.maybe_initialize_distributed()
    device = resolve_device(cfg.get_path("device", "cuda"))
    loss_cfg = build_loss_config(cfg)
    model = build_model(cfg).to(device)
    train_ds, gt_train = build_dataset(cfg, "train")
    val_ds, gt_val = build_dataset(cfg, "val")
    # dataset-derived, so multistep/cyclic schedules scale correctly
    steps_per_epoch = max(len(train_ds) // int(cfg.dataset.tr_batch_size), 1)
    state = trainer.create_yolo_train_state(mesh.data_parallel(model),
                                            _optimizer(cfg, steps_per_epoch))
    class_weights, idf_logits, _rare = build_tfidf(cfg, gt_train, device)

    ckpt = ckpt_lib.CheckpointManager(os.path.join(out_dir, str(cfg.experiment.cp)))
    start_epoch = 0
    metric_mode = "max" if cfg.metric == "mAP" else "min"
    best = -np.inf if metric_mode == "max" else np.inf
    if cfg.resume:
        restored = ckpt.restore("last", state)
        if restored:
            state, start_epoch, _ = restored
            start_epoch += 1
            log.info("resumed from epoch %d", start_epoch)

    plateau = optim_lib.PlateauState(
        factor=float(cfg.scheduler.get("factor", 0.1)),
        patience=int(cfg.scheduler.get("patience", 10)),
        mode=str(cfg.scheduler.get("mode", "max")))
    writer = log_lib.TensorBoardWriter(os.path.join(out_dir, "tb"))

    profile_steps = int(cfg.get_path("profile_steps", 0) or 0)
    for epoch in range(start_epoch, int(cfg.epochs)):
        t0 = time.time()
        # a torch.profiler trace of the first epoch (SURVEY.md §5.1)
        prof = _profiler(out_dir, device) if profile_steps and epoch == start_epoch else None
        if prof is not None:
            prof.start()
        state, sub, stats = train_one_epoch(state, cfg, loss_cfg, train_ds, epoch,
                                            class_weights, idf_logits, writer, ckpt)
        if prof is not None:
            prof.stop()
        if sub is None:
            log.error("epoch %d aborted on non-finite loss", epoch)
            break
        if cfg.metric == "mAP":
            metric, _ = test_one_epoch(state, cfg, loss_cfg, val_ds, gt_val,
                                       idf_logits=idf_logits)
        else:
            metric = valid_one_epoch(state, cfg, loss_cfg, val_ds)
        if str(cfg.scheduler.name) == "reduce_on_plateau":
            state.optimizer.plateau_scale = plateau.update(metric)
        best = ckpt.save_epoch(state, epoch, {"metric": metric}, metric, best, metric_mode)
        if mesh.process_index() == 0:
            log_lib.write_progress_stats(os.path.join(out_dir, "progress", "progress.csv"),
                                         epoch, sub, stats, metric)
            for n_, v in zip(["xy", "wh", "iou", "pos_conf", "neg_conf", "cls"], sub):
                writer.scalar(f"loss/{n_}", float(v), epoch)
            for n_, v in zip(["avg_iou", "pos_conf", "no_obj_conf", "pos_class", "neg_class"],
                             stats):
                writer.scalar(f"stats/{n_}", float(v), epoch)
            writer.scalar(f"metric/{cfg.metric}", metric, epoch)
        log.info("epoch %d done in %.1fs %s=%.4f (best %.4f)",
                 epoch, time.time() - t0, cfg.metric, metric, best)
    writer.close()
    return state, best


def evaluate_pipeline(cfg: Config, checkpoint_tag: str = "best", dump_json: str | None = None):
    device = resolve_device(cfg.get_path("device", "cuda"))
    loss_cfg = build_loss_config(cfg)
    # the same optimizer as training, so that the saved state loads
    state = trainer.create_yolo_train_state(build_model(cfg).to(device), _optimizer(cfg, 1))
    out_dir = str(cfg.get_path("output_dir", "output/default"))
    ckpt = ckpt_lib.CheckpointManager(os.path.join(out_dir, str(cfg.experiment.cp)))
    restored = ckpt.restore(checkpoint_tag, state)
    if restored:
        state = restored[0]
    val_ds, gt_val = build_dataset(cfg, "val")
    _, gt_train = build_dataset(cfg, "train")
    _, idf_logits, _ = build_tfidf(cfg, gt_train, device)
    mAP, ev = test_one_epoch(state, cfg, loss_cfg, val_ds, gt_val, idf_logits=idf_logits)
    if dump_json:
        ev.save_detections(dump_json)
    print(f"mAP: {mAP:.4f}")
    return mAP


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["train", "evaluate"])
    ap.add_argument("overrides", nargs="*",
                    help="config overrides: group=name or a.b=value (device=cpu for the CPU)")
    ap.add_argument("--config-dir", default=CONFIG_DIR)
    ap.add_argument("--checkpoint", default="best")
    ap.add_argument("--dump-json", default=None)
    args = ap.parse_args(argv)

    cfg = load_config(args.config_dir, args.overrides)
    if args.command == "train":
        return train_pipeline(cfg)
    return evaluate_pipeline(cfg, args.checkpoint, args.dump_json)


if __name__ == "__main__":
    main()
