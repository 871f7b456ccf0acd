"""The model adapter of ``detection_main`` (port of the JAX package's
``detection_main.py:ModelAdapter``): one entry that builds, trains and
evaluates the five architectures of its ``--model`` choice —
``fasterrcnn_resnet50_fpn``, ``maskrcnn_resnet50_fpn``,
``keypointrcnn_resnet50_fpn``, ``retinanet_resnet50_fpn`` and
``ssd300_vgg16``.

In place of the JAX ``init_variables`` the adapter builds the torch module
with seeded random weights (a ``torch.Generator`` seeded with ``seed``, on
the CPU, at the Flax initializers' scales) and moves it to ``device``,
``"cuda"`` unless the caller asks for the CPU. ``losses`` puts the model in
training mode (no fused eval blocks) and returns the loss dict;
``detect`` runs it in eval mode without autograd. GT labels are 1-based
with 0 the background; RetinaNet's loss takes them 0-based
(``clamp(labels - 1, 0)``) and its ``detect`` returns them 1-based again.
The CLI around the adapter (``main``, its batches, evaluation and
checkpoints) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.models import anchors as anchor_lib
from object_detectors_tpu_torch.models import faster_rcnn as FR
from object_detectors_tpu_torch.models import keypoint_rcnn as KR
from object_detectors_tpu_torch.models import mask_rcnn as MR
from object_detectors_tpu_torch.models import retinanet as RN
from object_detectors_tpu_torch.models import ssd as SSD
from object_detectors_tpu_torch.models.roi_heads import RoIHeadsConfig
from object_detectors_tpu_torch.models.rpn import RPNConfig

TWO_STAGE = ("fasterrcnn_resnet50_fpn", "maskrcnn_resnet50_fpn", "keypointrcnn_resnet50_fpn")
MODELS = TWO_STAGE + ("retinanet_resnet50_fpn", "ssd300_vgg16")


class ModelAdapter:
    """Build, loss and detections of one architecture."""

    def __init__(self, name: str, num_classes: int, image_size: int, loss_type: str = "ce",
                 tfidf=1.0, resnet_layers=(3, 4, 6, 3), small: bool = False,
                 class_weights=None, tfidf_mini_batch: bool = False, tfidf_norm: int = 0,
                 device: str | torch.device = "cuda", seed: int = 0):
        if name not in MODELS:
            raise ValueError(name)
        self.name = name
        self.image_size = image_size
        self.device = resolve_device(device)
        # the two-stage models take tfidf as a vector (None = off)
        vector = np.ndim(tfidf) > 0
        self.tfidf = (torch.as_tensor(np.asarray(tfidf), dtype=torch.float32, device=self.device)
                      if vector else tfidf)
        self.tfidf_vec = self.tfidf if vector else None
        self.class_weights = (None if class_weights is None else torch.as_tensor(
            np.asarray(class_weights), dtype=torch.float32, device=self.device))
        rpn_cfg = RPNConfig() if not small else RPNConfig(
            pre_nms_top_n_train=64, pre_nms_top_n_test=64, post_nms_top_n_train=32,
            post_nms_top_n_test=16, batch_size_per_image=32)
        roi_cfg = RoIHeadsConfig(
            num_classes=num_classes, loss_type=loss_type, tfidf_mini_batch=tfidf_mini_batch,
            tfidf_norm=tfidf_norm,
            **({"batch_size_per_image": 16, "detections_per_img": 10} if small else {}))
        layers = tuple(resnet_layers)
        if name == "fasterrcnn_resnet50_fpn":
            model = FR.init_frcnn_(FR.FasterRCNN(FR.FasterRCNNConfig(
                num_classes=num_classes, rpn=rpn_cfg, roi=roi_cfg, resnet_layers=layers)), seed)
        elif name == "maskrcnn_resnet50_fpn":
            model = MR.init_maskrcnn_(MR.MaskRCNN(MR.MaskRCNNConfig(
                num_classes=num_classes, rpn=rpn_cfg, roi=roi_cfg, resnet_layers=layers)), seed)
        elif name == "keypointrcnn_resnet50_fpn":
            model = KR.init_kprcnn_(KR.KeypointRCNN(KR.KeypointRCNNConfig(
                num_classes=num_classes, rpn=rpn_cfg, roi=roi_cfg, resnet_layers=layers,
                kp_head_layers=2 if small else 8, kp_head_features=64 if small else 512)), seed)
        elif name == "retinanet_resnet50_fpn":
            self.cfg = RN.RetinaNetConfig(num_classes=num_classes,
                                          tfidf_mini_batch=tfidf_mini_batch,
                                          tfidf_norm=tfidf_norm)
            model = RN.init_retinanet_(RN.RetinaNet(num_classes, layers), seed)
        else:
            self.cfg = SSD.SSDConfig(num_classes=num_classes, tfidf_mini_batch=tfidf_mini_batch,
                                     tfidf_norm=tfidf_norm)
            model = SSD.init_ssd_(SSD.SSD300(self.cfg), seed)
        self.model = model.to(self.device)
        self._anchors: dict = {}

    def _anchors_for(self) -> torch.Tensor:
        """RetinaNet's anchors: the ceil-chain grids of P3-P7, not s // stride."""
        if "retinanet" not in self._anchors:
            s = self.image_size
            sizes, ars = anchor_lib.retinanet_anchor_config()
            self._anchors["retinanet"] = torch.from_numpy(anchor_lib.grid_anchors(
                (s, s), anchor_lib.fpn_grid_sizes((s, s)), sizes, ars)).to(self.device)
        return self._anchors["retinanet"]

    def _ssd_anchors(self, level_sizes) -> torch.Tensor:
        """SSD's default boxes for the head's anchors per level."""
        key = tuple(level_sizes)
        if key not in self._anchors:
            grids = [(int(np.sqrt(ls / a)),) * 2
                     for ls, a in zip(level_sizes, SSD.ANCHORS_PER_LOCATION)]
            self._anchors[key] = torch.from_numpy(anchor_lib.ssd_default_boxes(
                (self.image_size, self.image_size), grids)).to(self.device)
        return self._anchors[key]

    def losses(self, batch: dict, generator: torch.Generator | None = None,
               uniforms=None) -> dict:
        """The loss dict of a batch (``images`` [B, H, W, 3] normalized,
        ``gt_boxes`` [B, M, 4], ``gt_labels`` [B, M] 1-based, ``gt_valid``
        [B, M]; ``gt_masks`` [B, M, H, W] for Mask R-CNN and
        ``gt_keypoints`` [B, M, K, 3] for Keypoint R-CNN, zeros when
        absent). The two-stage samplers draw from ``generator`` or take
        ``uniforms`` (``FasterRCNN.forward``)."""
        model = self.model.train()
        imgs = batch["images"]
        gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
        if self.name in TWO_STAGE:
            b, m = gt[1].shape
            if self.name == "maskrcnn_resnet50_fpn":
                gm = batch.get("gt_masks")
                gt += (gm if gm is not None else imgs.new_zeros((b, m) + imgs.shape[1:3]),)
            elif self.name == "keypointrcnn_resnet50_fpn":
                gkp = batch.get("gt_keypoints")
                gt += (gkp if gkp is not None else imgs.new_zeros((b, m, 17, 3)),)
            return model(imgs, *gt, train=True, tfidf=self.tfidf_vec,
                         class_weights=self.class_weights, generator=generator,
                         uniforms=uniforms)
        if self.name == "retinanet_resnet50_fpn":
            cls, reg, _ = model(imgs, train=True)
            return RN.retinanet_loss(cls.float(), reg.float(), self._anchors_for(), gt[0],
                                     (gt[1] - 1).clamp(min=0), gt[2], self.cfg,
                                     tfidf=self.tfidf)
        cls, reg, level_sizes = model(imgs)
        return SSD.ssd_loss(cls.float(), reg.float(), self._ssd_anchors(level_sizes), *gt,
                            self.cfg, tfidf=self.tfidf)

    @torch.no_grad()
    def _eval(self, images: torch.Tensor):
        return self.model.eval()(images, tfidf=self.tfidf_vec)

    @torch.no_grad()
    def detect(self, images: torch.Tensor):
        """images [B, H, W, 3] normalized -> (boxes [B, D, 4], scores,
        labels 1-based, valid)."""
        s = self.image_size
        if self.name in TWO_STAGE:
            return self._eval(images)[:4]
        model = self.model.eval()
        cls, reg, level_sizes = model(images)
        if self.name == "retinanet_resnet50_fpn":
            b, sc, lab, v = RN.retinanet_postprocess(cls, reg, self._anchors_for(),
                                                     tuple(level_sizes), (s, s), self.cfg,
                                                     tfidf_post=self.tfidf)
            return b, sc, lab + 1, v  # 1-based for the evaluator
        return SSD.ssd_postprocess(cls.float(), reg.float(), self._ssd_anchors(level_sizes),
                                   (s, s), self.cfg, tfidf_post=self.tfidf)

    def detect_with_masks(self, images: torch.Tensor):
        """Mask R-CNN only: (boxes, scores, labels, valid, masks [B, D, 28,
        28] probabilities)."""
        if self.name != "maskrcnn_resnet50_fpn":
            raise ValueError(f"detect_with_masks needs maskrcnn_resnet50_fpn, not {self.name}")
        return self._eval(images)

    def detect_with_keypoints(self, images: torch.Tensor):
        """Keypoint R-CNN only: (boxes, scores, labels, valid, keypoints
        [B, D, K, 3], kp_scores [B, D, K])."""
        if self.name != "keypointrcnn_resnet50_fpn":
            raise ValueError(f"detect_with_keypoints needs keypointrcnn_resnet50_fpn, "
                             f"not {self.name}")
        return self._eval(images)
