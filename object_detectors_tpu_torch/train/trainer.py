"""Training steps (port of the JAX package's ``train/trainer.py`` and of the
Faster R-CNN steps of its ``detection_main.py``).

A ``TrainState`` holds the model (its parameters, and its batch-norm running
statistics as buffers), the optimizer and the step count; a step runs the
forward in train mode, the loss, the backward and the optimizer update in
place. Activations run in the model's ``dtype`` (bfloat16 for the YOLO
bench row), parameters and the loss in float32. The host reads nothing
inside a step: the metrics come back as tensors on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from object_detectors_tpu_torch.kernels.preprocess import (
    rcnn_resize_normalize_from_canvas, resize_normalize_from_canvas,
)
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.train.optim import ScheduledOptimizer


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: ScheduledOptimizer
    step: int = 0
    # make_priors once per loss configuration, grids and device
    priors: dict = dataclasses.field(default_factory=dict)


def create_yolo_train_state(model: nn.Module, tx: Callable[..., ScheduledOptimizer],
                            device: str | torch.device | None = None) -> TrainState:
    """``tx`` is ``optim.make_optimizer(...)``; the model (already
    initialized) moves to ``device`` first when one is given."""
    if device is not None:
        model = model.to(device)
    return TrainState(model=model, optimizer=tx(model.parameters()))


def create_frcnn_train_state(model: nn.Module, tx: Callable[..., ScheduledOptimizer],
                             device: str | torch.device | None = None) -> TrainState:
    """As ``create_yolo_train_state``, with the model put in training mode
    (no fused eval blocks in its backbone), which ``FasterRCNN(train=True)``
    requires."""
    return create_yolo_train_state(model.train(), tx, device)


def _priors(state: TrainState, cfg: YC.YoloLossConfig, outputs, device: torch.device):
    """The priors of the raw maps ``outputs``, cached on the state."""
    key = (cfg, tuple(o.shape[1] for o in outputs), str(device))
    if key not in state.priors:
        state.priors[key] = YC.make_priors(cfg, key[1], device)
    return state.priors[key]


def yolo_forward_loss(state: TrainState, images: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor, cfg: YC.YoloLossConfig,
                      num_classes: int, anchors_per_scale: int = 3,
                      class_weights: torch.Tensor | None = None,
                      idf_logits: torch.Tensor | float = 1.0):
    """The forward in train mode and ``yolo_loss``: (loss, sub_losses,
    stats)."""
    outputs = state.model(images, train=True)
    raw = YC.flatten_raw_outputs(outputs, num_classes, anchors_per_scale).float()
    priors, grid_w = _priors(state, cfg, outputs, raw.device)
    return YC.yolo_loss(raw, priors, grid_w, gt_boxes, gt_labels, gt_valid, cfg,
                        class_weights=class_weights, idf_logits=idf_logits)


def backward_and_update(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """The backward of ``loss`` and the optimizer update; returns the global
    norm of the gradients before the update."""
    state.optimizer.zero_grad()
    loss.backward()
    # optax.global_norm: sqrt of the sum of squares of every element
    grad_norm = torch.nn.utils.get_total_norm(
        [p.grad for p in state.model.parameters() if p.grad is not None])
    state.optimizer.step()
    state.step += 1
    return grad_norm


def yolo_train_step(state: TrainState, images: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_labels: torch.Tensor, gt_valid: torch.Tensor, cfg: YC.YoloLossConfig,
                    num_classes: int, anchors_per_scale: int = 3,
                    class_weights: torch.Tensor | None = None,
                    idf_logits: torch.Tensor | float = 1.0):
    """One step. images [B, H, W, 3] float (H == W == cfg.img_size), GT
    padded. Updates ``state`` in place and returns (state, metrics): loss,
    sub_losses (xy, wh, iou, pos_conf, neg_conf, cls), stats (avg_iou,
    pos_conf, no_obj_conf, pos_class, neg_class) and grad_norm, the global
    norm of the gradients before the update."""
    loss, sub, stats = yolo_forward_loss(state, images, gt_boxes, gt_labels, gt_valid, cfg,
                                         num_classes, anchors_per_scale, class_weights,
                                         idf_logits)
    grad_norm = backward_and_update(state, loss)
    return state, {"loss": loss.detach(), "sub_losses": sub.detach(), "stats": stats,
                   "grad_norm": grad_norm}


def yolo_train_step_ingest(state: TrainState, canvas: torch.Tensor, sizes: torch.Tensor,
                           gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                           gt_valid: torch.Tensor, cfg: YC.YoloLossConfig, num_classes: int,
                           out_dim: int | None = None, anchors_per_scale: int = 3,
                           class_weights: torch.Tensor | None = None,
                           idf_logits: torch.Tensor | float = 1.0):
    """Device-ingest step (JAX ``train/trainer.py:yolo_train_step_ingest``):
    a uint8 canvas [B, Hc, Wc, 3] with the true (h, w) ``sizes`` [B, 2] is
    bicubic-resized to ``out_dim`` (default ``cfg.img_size``) and normalized
    in f32 on its device (``resize_normalize_from_canvas``), then
    ``yolo_train_step``. GT is relative cxcywh, so the resize never touches
    it."""
    images = resize_normalize_from_canvas(canvas, sizes, out_dim or cfg.img_size,
                                          torch.float32)
    return yolo_train_step(state, images, gt_boxes, gt_labels, gt_valid, cfg, num_classes,
                           anchors_per_scale, class_weights, idf_logits)


@torch.no_grad()
def yolo_eval_step(state: TrainState, images: torch.Tensor, cfg: YC.YoloLossConfig,
                   num_classes: int, anchors_per_scale: int = 3,
                   idf_logits: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Eval decode: images -> [B, P, 5+C] decoded predictions."""
    outputs = state.model(images, train=False)
    raw = YC.flatten_raw_outputs(outputs, num_classes, anchors_per_scale).float()
    priors, grid_w = _priors(state, cfg, outputs, raw.device)
    return YC.yolo_decode(raw, priors, grid_w, cfg, idf_logits)


def multiscale_sizes(base: int, lower: float = 0.5, upper: float = 1.5,
                     divisor: int = 32) -> tuple:
    """The multiscale training resolutions: the multiples of ``divisor`` in
    [lower * base, upper * base]."""
    lo = int(base * lower) // divisor
    hi = int(base * upper) // divisor
    return tuple(d * divisor for d in range(lo, hi + 1))


def draw_generator(seed: int, index: int, device: str | torch.device = "cpu") -> torch.Generator:
    """A generator on ``device`` seeded from (seed, index): the counterpart
    of JAX's ``fold_in(key(seed), index)``, so that every process draws the
    same and a resumed run draws what an uninterrupted one would."""
    words = np.random.SeedSequence([seed, index]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)


def pick_scale(generator: torch.Generator, sizes: Sequence[int]) -> int:
    """A resolution drawn uniformly from ``sizes`` with ``generator``."""
    idx = int(torch.randint(len(sizes), (), generator=generator))
    return sizes[idx]


def frcnn_forward_loss(state: TrainState, images: torch.Tensor, gt_boxes: torch.Tensor,
                       gt_labels: torch.Tensor, gt_valid: torch.Tensor, tfidf=None,
                       class_weights=None, generator: torch.Generator | None = None,
                       uniforms=None):
    """``FasterRCNN(train=True)`` on a model in training mode (see
    ``create_frcnn_train_state``): (the four losses summed in their dict's
    order, the dict). The samplers draw from ``generator``, or take
    ``uniforms`` (see ``FasterRCNN.forward``)."""
    losses = state.model(images, gt_boxes, gt_labels, gt_valid, train=True, tfidf=tfidf,
                   class_weights=class_weights, generator=generator, uniforms=uniforms)
    return sum(losses.values()), losses


def frcnn_train_step(state: TrainState, images: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor, tfidf=None,
                     class_weights=None, generator: torch.Generator | None = None,
                     uniforms=None):
    """One Faster R-CNN step, as ``detection_main``'s: the summed losses,
    backward, the optimizer update. Returns (state, total loss, the loss
    dict)."""
    total, losses = frcnn_forward_loss(state, images, gt_boxes, gt_labels, gt_valid, tfidf,
                                       class_weights, generator, uniforms)
    backward_and_update(state, total)
    return state, total.detach(), {k: v.detach() for k, v in losses.items()}


def frcnn_train_step_ingest(state: TrainState, canvas: torch.Tensor, sizes: torch.Tensor,
                            gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                            gt_valid: torch.Tensor, out_hw: tuple,
                            min_sizes: torch.Tensor | None = None, min_size: int = 800,
                            max_size: int = 1333, tfidf=None, class_weights=None,
                            generator: torch.Generator | None = None, uniforms=None):
    """Device-ingest Faster R-CNN step (JAX ``detection_main.py:train_step_u8``):
    a uint8 canvas [B, Hc, Wc, 3] at native resolution with its true (h, w)
    ``sizes`` gets the per-image min/max-size bilinear resize, normalize and
    zero pad to ``out_hw`` on its device (``rcnn_resize_normalize_from_canvas``;
    ``min_sizes`` [B] replays the host's drawn min sizes, against which the
    GT boxes were scaled), then ``frcnn_train_step``. Returns what that
    returns."""
    images, _, _ = rcnn_resize_normalize_from_canvas(canvas, sizes, out_hw, min_size,
                                                     max_size, torch.float32, min_sizes)
    return frcnn_train_step(state, images, gt_boxes, gt_labels, gt_valid, tfidf,
                            class_weights, generator, uniforms)


def create_detection_train_state(adapter, tx: Callable[..., ScheduledOptimizer]) -> TrainState:
    """The train state of a ``detection_main.ModelAdapter``'s model, put in
    training mode (no fused eval blocks), on the adapter's device."""
    return create_frcnn_train_state(adapter.model, tx)


def detection_train_step(state: TrainState, adapter, batch: dict,
                         generator: torch.Generator | None = None, uniforms=None):
    """One step of any ``ModelAdapter`` architecture, as ``detection_main``'s
    ``_train_step_impl``: ``adapter.losses`` summed in the dict's order,
    backward, the optimizer update. The two-stage samplers draw from
    ``generator`` or take ``uniforms``. Returns (state, total loss, the loss
    dict)."""
    losses = adapter.losses(batch, generator, uniforms)
    total = sum(losses.values())
    backward_and_update(state, total)
    return state, total.detach(), {k: v.detach() for k, v in losses.items()}
