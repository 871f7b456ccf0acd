"""Serving pipelines: uint8 or normalized images -> boxes, scores, labels,
valid.

YOLOv3: port of ``bench.py:build_pipeline`` / ``build_pipeline_uint8`` of
the JAX repository (``serve.build_yolo_pipeline`` runs it at top-512), with
the same defaults (80 classes, 640², top-256, 100 detections, conf 0.1, IoU 0.6,
bf16). The steps: YOLOv3 raw maps -> score = sigmoid(obj) * softmax-max ->
exact blocked top-k -> decode of the selected rows only -> class-agnostic
majority-vote NMS. The uint8 variant puts the normalize kernel in front.

Faster R-CNN: port of the ``frcnn640`` graph of ``bench.py:run_frcnn``
(91 classes, 640², bf16): the normalize kernel, then ``FasterRCNN``.

RetinaNet: port of ``serve.py:build_retinanet_pipeline(uint8_input=True)``
(``serve.build_retinanet_pipeline`` also takes normalized floats), the
``retinanet640`` graph of ``bench.py:run_retinanet`` (91 classes, 640²,
bf16): the normalize kernel, ``RetinaNet``, then ``retinanet_postprocess``
with the default tfidf of 1.0 against anchors made once for the image size.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.kernels.preprocess import preprocess_images
from object_detectors_tpu_torch.models import anchors as anchor_lib
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.models.faster_rcnn import (
    FasterRCNN, FasterRCNNConfig, init_frcnn_,
)
from object_detectors_tpu_torch.models.retinanet import (
    RetinaNet, RetinaNetConfig, init_retinanet_, retinanet_postprocess,
)
from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
from object_detectors_tpu_torch.ops.nms import exact_blocked_topk, gather_rows, nms_majority

ANCHORS_PER_SCALE = 3


class YoloPipeline:
    """Callable serving graph around one ``YoloHead`` on one device.

    Stages: ``raw_outputs`` (normalize + network), ``select`` (score, top-k,
    decode), ``nms``; ``candidates`` runs the first two and calling the
    pipeline runs all three. With ``uint8=True`` the input is a uint8
    ``[B, H, W, 3]`` batch normalized by ``preprocess_images``; otherwise it
    is an already normalized float batch.
    """

    def __init__(self, model: YoloHead, device: torch.device, num_classes: int,
                 img_size: int, topk: int, max_det: int, dtype: torch.dtype,
                 conf: float, iou_thr: float, uint8: bool):
        self.model = model
        self.num_classes = num_classes
        self.img_size = img_size
        self.topk = topk
        self.max_det = max_det
        self.dtype = dtype
        self.conf = conf
        self.iou_thr = iou_thr
        self.uint8 = uint8
        cfg = YC.YoloLossConfig(num_classes=num_classes, img_size=img_size)
        grids = (img_size // 32, img_size // 16, img_size // 8)
        self.priors, self.grid_w = YC.make_priors(cfg, grids, device)

    @torch.inference_mode()
    def raw_outputs(self, images: torch.Tensor):
        """The three NHWC raw maps for an input batch on this device."""
        if self.uint8:
            images = preprocess_images(images, self.dtype)
        return self.model(images)

    @torch.inference_mode()
    def select(self, outs):
        """Raw maps -> top-k candidates (boxes [B, k, 4] xyxy, scores [B, k],
        labels [B, k], valid [B, k] = scores > conf)."""
        raw = YC.flatten_raw_outputs(outs, self.num_classes, ANCHORS_PER_SCALE)
        obj = raw[..., 4].float()
        logits = raw[..., 5:].float()
        score = torch.sigmoid(obj) * torch.exp(logits.amax(-1) - torch.logsumexp(logits, -1))
        label = torch.argmax(logits, -1).to(torch.int32)

        topv, topi = exact_blocked_topk(score, self.topk)
        # decode only the selected rows
        sel = gather_rows(raw[..., :4].float(), topi)
        xy, wh = YC._decode(sel, self.priors[topi], self.grid_w[topi], self.img_size)
        boxes = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        labels = torch.gather(label, 1, topi)
        return boxes, topv, labels, topv > self.conf

    def candidates(self, images: torch.Tensor):
        """Everything before NMS: ``select(raw_outputs(images))``."""
        return self.select(self.raw_outputs(images))

    @torch.inference_mode()
    def nms(self, boxes, scores, labels, valid):
        """(boxes [B, max_det, 4], scores, labels, valid) after majority NMS."""
        return nms_majority(boxes, scores, labels, num_classes=self.num_classes,
                            iou_threshold=self.iou_thr, max_output=self.max_det,
                            valid=valid)

    def __call__(self, images: torch.Tensor):
        return self.nms(*self.candidates(images))


def place_model(model, make, dtype: torch.dtype, device: torch.device):
    """The model a pipeline runs: ``make()`` when ``model`` is None, else a
    copy of ``model`` (the caller's stays on its device and dtype), with
    activations in ``dtype``, in eval mode on ``device``."""
    model = make() if model is None else copy.deepcopy(model)
    model.dtype = dtype
    return model.to(device).eval()


def build_pipeline(num_classes: int = 80, img_size: int = 640, topk: int = 256,
                   max_det: int = 100, dtype: torch.dtype = torch.bfloat16,
                   conf: float = 0.1, iou_thr: float = 0.6,
                   model: YoloHead | None = None,
                   backbone_layers: Sequence[int] = (1, 2, 8, 8, 4),
                   device: str | torch.device = "cuda", uint8: bool = False) -> YoloPipeline:
    """Float-input YOLOv3 pipeline. Without ``model``, a ``YoloHead`` of
    ``backbone_layers`` gets the seeded random init (seed 0); a given model is
    copied, so the caller's stays on its device and dtype, and the copy runs
    its parameters as they are with activations in ``dtype``."""
    dev = resolve_device(device)
    model = place_model(model, lambda: init_yolo_(YoloHead(
        num_classes, ANCHORS_PER_SCALE, tuple(backbone_layers))), dtype, dev)
    return YoloPipeline(model, dev, num_classes, img_size, topk, max_det, dtype,
                        conf, iou_thr, uint8)


def build_pipeline_uint8(num_classes: int = 80, img_size: int = 640, topk: int = 256,
                         max_det: int = 100, dtype: torch.dtype = torch.bfloat16,
                         conf: float = 0.1, iou_thr: float = 0.6, **kwargs) -> YoloPipeline:
    """uint8-input variant: the normalize kernel in front of the same graph."""
    return build_pipeline(num_classes, img_size, topk, max_det, dtype, conf, iou_thr,
                          uint8=True, **kwargs)


class FrcnnPipeline:
    """Callable uint8 Faster R-CNN graph around one ``FasterRCNN`` on one
    device: ``preprocess_images`` then the model."""

    def __init__(self, model: FasterRCNN, dtype: torch.dtype, img_size: int):
        self.model = model
        self.dtype = dtype
        self.img_size = img_size

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor, on_stage=None):
        """uint8 [B, img_size, img_size, 3] -> (boxes [B, 100, 4], scores,
        labels 1-based, valid). ``on_stage(name)``, when given, is called
        after each stage."""
        if tuple(images.shape[1:]) != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected [B, {self.img_size}, {self.img_size}, 3] images, "
                             f"got {tuple(images.shape)}")
        x = preprocess_images(images, self.dtype)
        if on_stage is not None:
            on_stage("normalize")
        return self.model(x, on_stage=on_stage)


def build_frcnn_pipeline_uint8(num_classes: int = 91, img_size: int = 640,
                               dtype: torch.dtype = torch.bfloat16,
                               device: str | torch.device = "cuda",
                               model: FasterRCNN | None = None) -> FrcnnPipeline:
    """The ``frcnn640`` graph. Without ``model``, a ResNet-50-FPN
    ``FasterRCNN`` of ``num_classes`` gets the seeded random init (seed 0); a
    given model is copied, so the caller's stays on its device and dtype,
    and the copy runs its parameters as they are with activations in
    ``dtype``."""
    model = place_model(model, lambda: init_frcnn_(FasterRCNN(FasterRCNNConfig(
        num_classes=num_classes))), dtype, resolve_device(device))
    return FrcnnPipeline(model, dtype, img_size)


class RetinanetPipeline:
    """Callable RetinaNet graph around one ``RetinaNet`` on one device:
    ``preprocess_images`` (with ``uint8=True``; otherwise the input is an
    already normalized float batch), the model, ``retinanet_postprocess``."""

    def __init__(self, model: RetinaNet, dtype: torch.dtype, img_size: int, device,
                 uint8: bool = True):
        self.model = model
        self.dtype = dtype
        self.img_size = img_size
        self.uint8 = uint8
        self.cfg = RetinaNetConfig(num_classes=model.head.num_classes)
        s = (img_size, img_size)
        sizes, ratios = anchor_lib.retinanet_anchor_config()
        self.anchors = torch.from_numpy(anchor_lib.grid_anchors(
            s, anchor_lib.fpn_grid_sizes(s), sizes, ratios)).to(device)

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor, on_stage=None):
        """[B, img_size, img_size, 3] -> (boxes [B, 300, 4], scores, labels
        0-based (-1 where not valid), valid). ``on_stage(name)``, when given,
        is called after each stage: normalize (uint8 input only),
        backbone+FPN, head, select, cap+decode, NMS."""
        if tuple(images.shape[1:]) != (self.img_size, self.img_size, 3):
            raise ValueError(f"expected [B, {self.img_size}, {self.img_size}, 3] images, "
                             f"got {tuple(images.shape)}")
        if self.uint8:
            images = preprocess_images(images, self.dtype)
            if on_stage is not None:
                on_stage("normalize")
        cls, reg, level_sizes = self.model(images, on_stage=on_stage)
        if sum(level_sizes) != self.anchors.shape[0]:
            raise ValueError(f"the head gave {sum(level_sizes)} anchors, the grid "
                             f"{self.anchors.shape[0]}")
        return retinanet_postprocess(cls, reg, self.anchors, level_sizes,
                                     (self.img_size, self.img_size), self.cfg,
                                     on_stage=on_stage)


def build_retinanet_pipeline_uint8(num_classes: int = 91, img_size: int = 640,
                                   dtype: torch.dtype = torch.bfloat16,
                                   device: str | torch.device = "cuda",
                                   model: RetinaNet | None = None) -> RetinanetPipeline:
    """The ``retinanet640`` graph. Without ``model``, a ResNet-50-FPN
    ``RetinaNet`` of ``num_classes`` gets the seeded random init (seed 0),
    backbone unfused; a given model is copied, so the caller's stays on its
    device and dtype, and the copy runs its parameters as they are with
    activations in ``dtype``."""
    dev = resolve_device(device)
    model = place_model(model, lambda: init_retinanet_(RetinaNet(num_classes)), dtype, dev)
    return RetinanetPipeline(model, dtype, img_size, dev)
