"""Faster R-CNN with a ResNet-FPN backbone, inference only (port of the JAX
package's ``models/faster_rcnn.py``): backbone + FPN (P2-P6) -> RPN head ->
anchors, decode and proposal filter -> multiscale RoIAlign over P2-P5 ->
TwoMLPHead -> FastRCNNPredictor -> postprocess. Activations run in
``dtype``; parameters, anchors and box math stay float32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from object_detectors_tpu_torch.models import anchors as anchor_lib
from object_detectors_tpu_torch.models.resnet import BackboneWithFPN, ResNet
from object_detectors_tpu_torch.models.roi_heads import (
    FastRCNNPredictor, RoIHeadsConfig, TwoMLPHead, postprocess_detections,
)
from object_detectors_tpu_torch.models.rpn import RPNConfig, RPNHead, filter_proposals
from object_detectors_tpu_torch.ops.boxes import decode_boxes
from object_detectors_tpu_torch.ops.roi_align import pool_multiscale


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    num_classes: int = 91
    rpn: RPNConfig = RPNConfig()
    roi: RoIHeadsConfig = RoIHeadsConfig()
    resnet_layers: tuple = (3, 4, 6, 3)
    backbone_fused: str = "off"  # fused eval bottlenecks (models/resnet.py)


class FasterRCNN(nn.Module):
    """Images [B, H, W, 3] (the JAX layout, normalized) -> (boxes [B, D, 4],
    scores [B, D], labels [B, D] 1-based, valid [B, D])."""

    def __init__(self, cfg: FasterRCNNConfig = FasterRCNNConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        oh, ow = cfg.roi.pool_size
        self.backbone = BackboneWithFPN(ResNet(cfg.resnet_layers, fused=cfg.backbone_fused), 256)
        self.rpn_head = RPNHead(256, 3)
        self.box_head = TwoMLPHead(256 * oh * ow, 1024)
        self.box_predictor = FastRCNNPredictor(1024, cfg.num_classes)
        self._anchors: dict = {}

    def decode(self, feats, deltas: torch.Tensor, image_size) -> torch.Tensor:
        """RPN deltas [B, A_total, 4] -> proposals decoded against the
        anchors of these level maps (made once per image size, grids and
        device)."""
        grids = tuple(tuple(f.shape[-2:]) for f in feats)
        key = (tuple(image_size), grids, str(deltas.device))
        if key not in self._anchors:
            sizes, ratios = anchor_lib.rpn_anchor_config()
            self._anchors[key] = torch.from_numpy(anchor_lib.grid_anchors(
                image_size, grids, sizes[:len(grids)], ratios[:len(grids)])).to(deltas.device)
        return decode_boxes(deltas.float(), self._anchors[key][None], self.cfg.rpn.box_weights)

    def forward(self, images: torch.Tensor, train: bool = False, tfidf=None, on_stage=None):
        """``tfidf``: optional [num_classes] logit scale of the postprocess
        (the JAX ``tfidf_post``). ``on_stage(name)``, when given, is called
        after each stage."""
        if train:
            raise NotImplementedError("Faster R-CNN training is not ported yet")
        mark = on_stage or (lambda name: None)
        cfg = self.cfg
        _, h, w, _ = images.shape
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = self.backbone(x)
        mark("backbone+FPN")
        objectness, deltas, level_sizes = self.rpn_head(feats)
        mark("RPN head")
        boxes, _, valid = filter_proposals(self.decode(feats, deltas, (h, w)),
                                           objectness.float(), level_sizes, (h, w), cfg.rpn)
        mark("proposal filter")
        pooled = pool_multiscale(feats[:4], boxes, (h, w), cfg.roi.pool_size).to(self.dtype)
        mark("pooler")
        class_logits, box_regression = self.box_predictor(self.box_head(pooled))
        mark("box head")
        out = postprocess_detections(class_logits.float(), box_regression.float(), boxes,
                                     valid, (h, w), cfg.roi,
                                     tfidf_post=1.0 if tfidf is None else tfidf)
        mark("postprocess")
        return out


@torch.no_grad()
def init_frcnn_(model: FasterRCNN, seed: int = 0) -> FasterRCNN:
    """Random init from a seeded ``torch.Generator`` on the CPU, with the
    Flax initializers' scales: LeCun-normal convs and dense layers, normal
    0.01 for the RPN head and the class scores, 0.001 for the box deltas,
    zero biases, identity frozen batch norm."""
    g = torch.Generator().manual_seed(seed)
    special = {model.rpn_head.conv: 0.01, model.rpn_head.cls_logits: 0.01,
               model.rpn_head.bbox_pred: 0.01, model.box_predictor.cls_score: 0.01,
               model.box_predictor.bbox_pred: 0.001}
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = special.get(m, m.weight[0].numel() ** -0.5)
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * std)
            if m.bias is not None:
                m.bias.zero_()
    return model
