"""Faster R-CNN with a ResNet-FPN backbone (port of the JAX package's
``models/faster_rcnn.py``): backbone + FPN (P2-P6) -> RPN head -> anchors,
decode and proposal filter -> multiscale RoIAlign over P2-P5 -> TwoMLPHead
-> FastRCNNPredictor -> postprocess, or in training the four losses
(the RPN's on its anchors; the box head's on the sampled proposals and GT
boxes). Activations run in ``dtype``; parameters, anchors and box math stay
float32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from object_detectors_tpu_torch.models import anchors as anchor_lib
from object_detectors_tpu_torch.models.resnet import BackboneWithFPN, ResNet
from object_detectors_tpu_torch.models.roi_heads import (
    FastRCNNPredictor, RoIHeadsConfig, TwoMLPHead, fastrcnn_loss, postprocess_detections,
    select_training_samples, training_tfidf_scale,
)
from object_detectors_tpu_torch.models.rpn import (
    RPNConfig, RPNHead, filter_proposals, rpn_loss,
)
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
    scores [B, D], labels [B, D] 1-based, valid [B, D]); with ``train`` the
    loss dict."""

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

    def anchors(self, feats, image_size, device) -> torch.Tensor:
        """The anchors [A_total, 4] of these level maps, made once per image
        size, grids and device."""
        grids = tuple(tuple(f.shape[-2:]) for f in feats)
        key = (tuple(image_size), grids, str(device))
        if key not in self._anchors:
            sizes, ratios = anchor_lib.rpn_anchor_config()
            self._anchors[key] = torch.from_numpy(anchor_lib.grid_anchors(
                image_size, grids, sizes[:len(grids)], ratios[:len(grids)])).to(device)
        return self._anchors[key]

    def decode(self, feats, deltas: torch.Tensor, image_size) -> torch.Tensor:
        """RPN deltas [B, A_total, 4] -> proposals decoded against the
        anchors of these level maps."""
        return decode_boxes(deltas.float(), self.anchors(feats, image_size, deltas.device)[None],
                            self.cfg.rpn.box_weights)

    def forward(self, images: torch.Tensor, gt_boxes=None, gt_labels=None, gt_valid=None,
                train: bool = False, tfidf=None, class_weights=None,
                generator: torch.Generator | None = None, uniforms=None, on_stage=None):
        """``tfidf``: optional [num_classes] logit scale, of the training
        classification loss and of the postprocess (the JAX ``tfidf_post``).
        ``on_stage(name)``, when given, is called after each stage.

        ``train``: GT boxes [B, M, 4] xyxy, labels [B, M] 1-based, valid
        [B, M] -> dict(loss_classifier, loss_box_reg, loss_objectness,
        loss_rpn_box_reg); ``class_weights`` [num_classes] weigh the CE.
        The two samplers draw their uniforms from ``generator``, or take
        ``uniforms = {"rpn": (u_pos, u_neg) [B, A_total], "roi": (u_pos,
        u_neg) [B, P + M]}``. ``train`` needs the module in training mode:
        in eval mode the backbone may take the fused forward-only blocks,
        which pass no gradient."""
        self._check_train(train, gt_boxes, gt_labels, gt_valid)
        mark = on_stage or (lambda name: None)
        feats, objectness, deltas, level_sizes, size = self._trunk(images, mark)
        if train:
            return self._losses(feats, objectness, deltas, level_sizes, size, gt_boxes,
                                gt_labels, gt_valid, tfidf, class_weights, generator,
                                uniforms)[0]
        return self._detect(feats, objectness, deltas, level_sizes, size, tfidf, mark)

    def _check_train(self, train: bool, *gt):
        if train and any(t is None for t in gt):
            raise ValueError("train=True needs the ground truth (gt_boxes, gt_labels, gt_valid "
                             "and the targets of a mask or keypoint branch)")
        if train and not self.training:
            raise ValueError("train=True needs the module in training mode (model.train())")

    def _trunk(self, images: torch.Tensor, mark):
        """Backbone + FPN and the RPN head: (level maps, objectness f32,
        deltas f32, anchors per level, image size)."""
        _, h, w, _ = images.shape
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        feats = self.backbone(x.contiguous(memory_format=torch.channels_last))
        mark("backbone+FPN")
        objectness, deltas, level_sizes = self.rpn_head(feats)
        mark("RPN head")
        return feats, objectness.float(), deltas.float(), level_sizes, (h, w)

    def _detect(self, feats, objectness, deltas, level_sizes, image_size, tfidf, mark):
        """Proposal filter, pooler, box head and postprocess -> (boxes,
        scores, labels, valid)."""
        cfg = self.cfg
        boxes, _, valid = filter_proposals(self.decode(feats, deltas, image_size), objectness,
                                           level_sizes, image_size, cfg.rpn)
        mark("proposal filter")
        pooled = pool_multiscale(feats[:4], boxes, image_size, cfg.roi.pool_size).to(self.dtype)
        mark("pooler")
        class_logits, box_regression = self.box_predictor(self.box_head(pooled))
        mark("box head")
        out = postprocess_detections(class_logits.float(), box_regression.float(), boxes,
                                     valid, image_size, cfg.roi,
                                     tfidf_post=1.0 if tfidf is None else tfidf)
        mark("postprocess")
        return out

    def _losses(self, feats, objectness, deltas, level_sizes, image_size, gt_boxes, gt_labels,
                gt_valid, tfidf, class_weights, generator, uniforms):
        """The four losses, and the sampled slots (boxes, positive, matched
        GT index) [B, S] that a mask or keypoint branch trains on."""
        cfg = self.cfg
        uniforms = uniforms or {}
        anchors = self.anchors(feats, image_size, deltas.device)
        # the proposals take no gradient (the JAX stop_gradient)
        proposals = decode_boxes(deltas.detach(), anchors[None], cfg.rpn.box_weights)
        prop_boxes, _, prop_valid = filter_proposals(proposals, objectness, level_sizes,
                                                     image_size, cfg.rpn, training=True)
        rpn_losses = rpn_loss(objectness, deltas, anchors, gt_boxes, gt_valid, cfg.rpn,
                              uniforms.get("rpn"), generator)
        s_boxes, s_labels, reg_targets, s_pos, s_sampled, s_matched = select_training_samples(
            prop_boxes, prop_valid, gt_boxes, gt_labels, gt_valid, cfg.roi,
            uniforms.get("roi"), generator)
        pooled = pool_multiscale(feats[:4], s_boxes, image_size, cfg.roi.pool_size)
        class_logits, box_regression = self.box_predictor(self.box_head(pooled.to(self.dtype)))
        scale = training_tfidf_scale(gt_labels, gt_valid, cfg.roi, tfidf)
        det_losses = fastrcnn_loss(class_logits.float() * scale, box_regression.float(),
                                   s_labels, reg_targets, s_sampled, cfg.roi, class_weights)
        return {**det_losses, **rpn_losses}, (s_boxes, s_pos, s_matched)


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
