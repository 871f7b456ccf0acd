"""One train step of a tiny model of each family on the CPU and on the GPU,
from the same weights, inputs and sampler draws, and how far the two
updates differ. ``chip_smoke.py`` and the card-only tests run these.

Both devices run with TF32 off. The losses are computed before the
update: the YOLO ones agree within ``TRAIN_LOSS_RTOL``, the Faster R-CNN
ones within ``FRCNN_LOSS_RTOL``, because its RoIAlign backward sums with
atomics. cuDNN and the CPU sum the convolutions in other orders. An
activation within that noise of a (leaky) ReLU kink then takes another
derivative on each device. The tiny Darknet's batch norms (18 to 18 432
values a channel) spread such a flip over a channel. So its f32 update
holds only as a whole: the difference's norm within
``YOLO_F32_UPDATE_NORM`` of the update's (1.8 % seen on an H100). In f64
each tensor holds within ``YOLO_F64_UPDATE_SHARE`` of that tensor's largest
update (1.3e-7 seen there). Faster R-CNN's frozen batch norms do not spread
a flip, so each of its f32 tensors holds within ``FRCNN_UPDATE_SHARE``
(0.4 % seen). A wrong gradient is off by the size of the update itself.

``adapter_step_on_both`` takes one ``detection_train_step`` of a tiny model
of each further ``detection_main`` architecture (Mask and Keypoint R-CNN,
RetinaNet, SSD300) and is held to the Faster R-CNN tolerances: the
RoIAlign backward's atomics in the two-stage models, and no batch norm that
spreads a flip in any of them.

A tensor whose gradient is zero in exact arithmetic (Keypoint R-CNN's
keypoint logits' bias adds one constant to a whole heatmap, which the
softmax loss does not see) updates by rounding alone on each device. So
``update_gap`` takes each tensor's difference over its own largest update
or NULL_UPDATE_SHARE of the largest update of any tensor, whichever is
larger. That share lies between such a rounding update (2.6e-8 of the
largest, that bias on an H100) and the smallest update of a tensor with a
gradient in these steps (4.2e-6 of the largest, the tiny Faster R-CNN's
``backbone.fpn.layer3.weight`` on the CPU), so it holds the others to their
own updates.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from object_detectors_tpu_torch.models.common import tf32_off

TRAIN_LOSS_RTOL, FRCNN_LOSS_RTOL = 1e-4, 1e-3
YOLO_F32_UPDATE_NORM, YOLO_F64_UPDATE_SHARE, FRCNN_UPDATE_SHARE = 0.05, 1e-5, 0.05
NULL_UPDATE_SHARE = 3e-6


def update_gap(models: dict, before: dict) -> dict:
    """The GPU's parameter updates against the CPU's (``tensor_gap``)."""
    gpu = dict(models["cuda"].named_parameters())
    return tensor_gap(
        {name: (p.detach() - before[name]).double()
         for name, p in models["cpu"].named_parameters()},
        {name: (p.detach().cpu() - before[name]).double() for name, p in gpu.items()})


def tensor_gap(ref: dict, got: dict) -> dict:
    """Tensors ``got`` against ``ref`` (by name; updates or gradients).
    ``worst_share``: the largest difference in a tensor over the larger of
    that tensor's largest reference value and NULL_UPDATE_SHARE of the
    largest reference value of any tensor, the worst tensor's (named by
    ``at``). ``norm_share``: the norm of all differences over the norm of
    the reference."""
    diffs, num, den = {}, 0.0, 0.0
    for name, upd in ref.items():
        upd = upd.double()
        diff = got[name].double() - upd
        num += float((diff ** 2).sum())
        den += float((upd ** 2).sum())
        diffs[name] = diff.abs().max().item(), upd.abs().max().item()
    floor = NULL_UPDATE_SHARE * max(u for _, u in diffs.values())
    worst, at = 0.0, None
    for name, (d, u) in diffs.items():
        share = d / max(u, floor, 1e-30)
        if share > worst:
            worst, at = share, name
    return {"worst_share": worst, "at": at, "norm_share": (num / max(den, 1e-300)) ** 0.5}


def on_both(make: Callable[[], torch.nn.Module], step: Callable, dtype=torch.float32):
    """``step(model, device)`` on a fresh ``make()`` on the CPU and on the
    GPU in ``dtype``, with TF32 off: (models, the parameters before the
    step, the step's outputs), each keyed by device."""
    models, outs = {}, {}
    with tf32_off():
        for dev in ("cpu", "cuda"):
            models[dev] = make().to(dev, dtype)
            before = {k: p.detach().cpu().clone() for k, p in models[dev].named_parameters()}
            outs[dev] = step(models[dev], dev)
    return models, before, outs


def yolo_step_on_both(dtype=torch.float32, ingest: bool = False):
    """A tiny Darknet YOLO (``backbone_layers=(1, 1, 1, 1, 1)``, 4 classes,
    96 px, batch 2, 6 GT slots) takes one SGD step (lr 1e-3, weight decay
    5e-4, momentum 0.9) on each device. With ``ingest`` the images come as
    a uint8 canvas [2, 128, 128, 3] (true sizes 128² and 100 x 120) through
    ``yolo_train_step_ingest``, the resize on each device. Returns (models,
    parameters before, the step's metrics)."""
    from object_detectors_tpu_torch.models import yolo_criterion as YC
    from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
    from object_detectors_tpu_torch.train import optim, trainer

    cfg = YC.YoloLossConfig(num_classes=4, img_size=96)
    rng = np.random.RandomState(0)
    images, *gt = [torch.from_numpy(a) for a in (
        rng.rand(2, 96, 96, 3), (rng.rand(2, 6, 4) * 0.5 + 0.25).astype(np.float32),
        rng.randint(0, 4, (2, 6)), rng.rand(2, 6) < 0.7)]
    tx = optim.make_optimizer(optim.OptimizerConfig("sgd", 1e-3, 5e-4, 0.9),
                              optim.SchedulerConfig())
    canvas, sizes = _canvas(1, 128, [[128, 128], [100, 120]])

    def step(model, dev):
        state = trainer.create_yolo_train_state(model, tx)
        if ingest:
            return trainer.yolo_train_step_ingest(state, canvas.to(dev), sizes.to(dev),
                                                  *[t.to(dev) for t in gt], cfg, 4)[1]
        return trainer.yolo_train_step(state, images.to(dev, dtype), *[t.to(dev) for t in gt],
                                       cfg, 4)[1]

    return on_both(
        lambda: init_yolo_(YoloHead(4, backbone_layers=(1, 1, 1, 1, 1), dtype=dtype), seed=1),
        step, dtype)


def _canvas(seed: int, size: int, sizes):
    """A seeded uint8 canvas [len(sizes), size, size, 3] and its true (h, w)
    sizes, as CPU tensors."""
    rng = np.random.RandomState(seed)
    canvas = rng.randint(0, 256, (len(sizes), size, size, 3)).astype(np.uint8)
    return torch.from_numpy(canvas), torch.tensor(sizes, dtype=torch.int32)


def frcnn_step_on_both(ingest: bool = False):
    """A tiny Faster R-CNN (``resnet_layers=(1, 1, 1, 1)``, 5 classes,
    64 px, batch 2 with one background image) takes one SGD step (lr
    0.0025, weight decay 1e-4, momentum 0.9) on each device, both samplers
    on the same seeded uniforms. With ``ingest`` the images come as a uint8
    canvas [2, 96, 96, 3] (true sizes 96² and 72 x 90, drawn min sizes 64
    and 56, max size 107) through ``frcnn_train_step_ingest``. Returns
    (models, parameters before, the four losses, and the launches of the
    RoIAlign forward, its backward and NMS during each device's step)."""
    from object_detectors_tpu_torch.kernels import nms as KN
    from object_detectors_tpu_torch.kernels import roi_align as KR
    from object_detectors_tpu_torch.kernels import roi_align_bwd as KB
    from object_detectors_tpu_torch.models import faster_rcnn as F
    from object_detectors_tpu_torch.models import roi_heads as RH
    from object_detectors_tpu_torch.models import rpn as RPN
    from object_detectors_tpu_torch.train import optim, trainer

    cfg = F.FasterRCNNConfig(
        num_classes=5, rpn=RPN.RPNConfig(pre_nms_top_n_train=32, post_nms_top_n_train=16,
                                         batch_size_per_image=16),
        roi=RH.RoIHeadsConfig(num_classes=5, batch_size_per_image=8), resnet_layers=(1, 1, 1, 1))
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
    gt = torch.tensor([[[4.0, 4.0, 24.0, 24.0], [30.0, 30.0, 50.0, 44.0]]] * 2)
    labels, valid = torch.tensor([[1, 3]] * 2), torch.tensor([[True, True], [False, False]])
    a_total = 3 * (16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2 + 1)
    g = torch.Generator().manual_seed(2)
    draws = {"rpn": (torch.rand(2, a_total, generator=g), torch.rand(2, a_total, generator=g)),
             "roi": (torch.rand(2, 18, generator=g), torch.rand(2, 18, generator=g))}
    tx = optim.make_optimizer(optim.OptimizerConfig("sgd", 0.0025, 1e-4, 0.9),
                              optim.SchedulerConfig())
    canvas, sizes = _canvas(2, 96, [[96, 96], [72, 90]])
    launches = {}

    def step(model, dev):
        state = trainer.create_frcnn_train_state(model, tx)
        start = KR.launches, KB.launches, KN.launches
        targets = gt.to(dev), labels.to(dev), valid.to(dev)
        kw = dict(uniforms={k: tuple(t.to(dev) for t in v) for k, v in draws.items()})
        if ingest:
            out = trainer.frcnn_train_step_ingest(
                state, canvas.to(dev), sizes.to(dev), *targets, (64, 64),
                min_sizes=torch.tensor([64.0, 56.0], device=dev), max_size=107, **kw)[2]
        else:
            out = trainer.frcnn_train_step(state, x.to(dev), *targets, **kw)[2]
        launches[dev] = (KR.launches - start[0], KB.launches - start[1],
                         KN.launches - start[2])
        return out

    models, before, losses = on_both(lambda: F.init_frcnn_(F.FasterRCNN(cfg), seed=3), step)
    return models, before, losses, launches


def adapter_batch(name: str, size: int, seed: int = 4) -> dict:
    """A seeded batch for a ``detection_main`` architecture as CPU tensors:
    two normalized images, 3 GT slots (the second image one short), 1-based
    labels, and the masks or 17 keypoints a slot that Mask and Keypoint
    R-CNN train on."""
    rng = np.random.RandomState(seed)
    m = 3
    xy = rng.rand(2, m, 2) * size * 0.6
    boxes = np.concatenate([xy, xy + size * 0.1 + rng.rand(2, m, 2) * size * 0.3], -1)
    batch = {"images": rng.randn(2, size, size, 3).astype(np.float32),
             "gt_boxes": boxes.astype(np.float32),
             "gt_labels": rng.randint(1, 2 if name.startswith("keypoint") else 5, (2, m)),
             "gt_valid": np.array([[True] * m, [True] * (m - 1) + [False]])}
    if name.startswith("mask"):
        ys, xs = np.mgrid[:size, :size]
        b = boxes[:, :, :, None, None]
        batch["gt_masks"] = ((xs >= b[:, :, 0]) & (xs < b[:, :, 2]) & (ys >= b[:, :, 1])
                             & (ys < b[:, :, 3])).astype(np.float32)
    if name.startswith("keypoint"):
        lo, hi = boxes[:, :, None, :2], boxes[:, :, None, 2:]
        batch["gt_keypoints"] = np.concatenate(
            [lo + rng.rand(2, m, 17, 2) * (hi - lo), (rng.rand(2, m, 17, 1) < 0.8) * 2.0],
            -1).astype(np.float32)
    return {k: torch.from_numpy(a) for k, a in batch.items()}


def adapter_step_on_both(name: str):
    """A tiny model of ``name`` (``ModelAdapter`` with ``small=True``,
    ResNet (1, 1, 1, 1), 64 px; SSD300 at 300 px), 5 classes (Keypoint
    R-CNN 2), batch 2, takes one ``detection_train_step`` (SGD 0.0025,
    weight decay 1e-4, momentum 0.9) on each device from the same seeded
    weights, TF32 off, the two-stage samplers on the same seeded uniforms.
    Returns (models, parameters before, the losses, and the launches of the
    RoIAlign forward, its backward and NMS during each device's step)."""
    from object_detectors_tpu_torch import detection_main as DM
    from object_detectors_tpu_torch.kernels import nms as KN
    from object_detectors_tpu_torch.kernels import roi_align as KR
    from object_detectors_tpu_torch.kernels import roi_align_bwd as KB
    from object_detectors_tpu_torch.train import optim, trainer

    size = 300 if name.startswith("ssd") else 64
    ncls = 2 if name.startswith("keypoint") else 5
    batch = adapter_batch(name, size)
    a_total = 3 * (16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2 + 1)
    g = torch.Generator().manual_seed(2)
    draws = {"rpn": (torch.rand(2, a_total, generator=g), torch.rand(2, a_total, generator=g)),
             "roi": (torch.rand(2, 35, generator=g), torch.rand(2, 35, generator=g))}
    tx = optim.make_optimizer(optim.OptimizerConfig("sgd", 0.0025, 1e-4, 0.9),
                              optim.SchedulerConfig())
    models, outs, launches = {}, {}, {}
    with tf32_off():
        for dev in ("cpu", "cuda"):
            adapter = DM.ModelAdapter(name, ncls, size, resnet_layers=(1, 1, 1, 1), small=True,
                                      device=dev, seed=3)
            models[dev] = adapter.model
            before = {k: p.detach().cpu().clone() for k, p in adapter.model.named_parameters()}
            state = trainer.create_detection_train_state(adapter, tx)
            start = KR.launches, KB.launches, KN.launches
            uniforms = ({k: tuple(t.to(dev) for t in v) for k, v in draws.items()}
                        if name in DM.TWO_STAGE else None)
            outs[dev] = trainer.detection_train_step(
                state, adapter, {k: t.to(dev) for k, t in batch.items()}, uniforms=uniforms)[2]
            launches[dev] = (KR.launches - start[0], KB.launches - start[1],
                             KN.launches - start[2])
    return models, before, outs, launches
