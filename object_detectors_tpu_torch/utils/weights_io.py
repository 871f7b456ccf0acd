"""Pretrained weight import: Darknet binary ``.weights`` files and
torchvision state dicts -> the port's state dicts (port of the JAX
package's ``utils/weights_io.py``, which fills Flax trees).

Parity with `yolo/nets/yolohead.py:90-164` (the raw Darknet reader: 5 int32
header words, then a float32 stream in [bn_bias, bn_weight, bn_mean,
bn_var, conv_kernel] order per conv-bn block, [bias, kernel] for plain
convs) and `yolo/procedures/initialize.py:57-104` (torch checkpoints with
the DDP ``module.`` prefix stripped).

The port's modules keep the Flax module names and PyTorch's layouts, so a
torchvision tensor moves to its port key unchanged, with one exception:
``box_head.fc6`` flattens the pooled [C, 7, 7] features in (y, x, c)
order where torchvision flattens (c, y, x), so its input dimension is
permuted. Each converter is a table of (torchvision key, port key), and the
export to torchvision walks the same table backwards.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from object_detectors_tpu_torch.models.common import FrozenBatchNorm

_BN = ("weight", "bias", "running_mean", "running_var")


def darknet_block_order(layers=(1, 2, 8, 8, 4)):
    """The conv-bn blocks of ``DarkNet`` in the Darknet file's order (stem,
    then per stage: downsample + residual conv1/conv2 pairs), as module
    paths."""
    order = [("stem",)]
    for stage, blocks in enumerate(layers):
        order.append((f"down{stage + 1}",))
        for b in range(blocks):
            order.append((f"stage{stage + 1}_block{b}", "conv1"))
            order.append((f"stage{stage + 1}_block{b}", "conv2"))
    return order


def yolo_head_order(layers=(1, 2, 8, 8, 4)):
    """The whole ``YoloHead`` in the reference's module registration order
    (yolohead.py __init__: backbone, embedding0, embedding1_cbl, embedding1,
    embedding2_cbl, embedding2)."""
    order = [("backbone",) + p for p in darknet_block_order(layers)]
    for emb, lateral in (("embedding0", None), ("embedding1", "lateral1"),
                         ("embedding2", "lateral2")):
        if lateral:
            order.append((lateral,))
        for i in range(6):
            order.append((emb, f"cbl{i}"))
        order.append((emb, "conv_out"))
    return order


def _conv_bn_order(state_dict: dict, explicit_order=None):
    """(module prefix, is conv-bn) for every conv-bn block and plain conv of
    ``state_dict``: in ``explicit_order`` (module paths) when given, else in
    the state dict's own order."""
    if explicit_order is not None:
        for path in explicit_order:
            prefix = ".".join(path)
            yield prefix, f"{prefix}.conv.weight" in state_dict
        return
    seen = set()
    for key, value in state_dict.items():
        if key.endswith(".conv.weight") and key[:-len(".conv.weight")] + ".bn.weight" in state_dict:
            prefix = key[:-len(".conv.weight")]
            if prefix not in seen:
                seen.add(prefix)
                yield prefix, True
        elif (key.endswith(".weight") and np.ndim(value) == 4 and ".conv." not in key
              and key[:-len(".weight")] + ".bias" in state_dict):
            yield key[:-len(".weight")], False


def load_darknet_weights(state_dict: dict, weights_path: str, explicit_order=None):
    """Load a raw Darknet ``.weights`` file into a copy of ``state_dict``
    (a ``YoloHead`` or ``DarkNet`` state dict). Returns (new state dict,
    floats consumed).

    ``explicit_order`` (module paths, see ``yolo_head_order``) is needed for
    whole-model files; backbone-only files (darknet53.conv.74) can pass
    ``darknet_block_order()`` on a ``DarkNet``."""
    with open(weights_path, "rb") as f:
        np.fromfile(f, dtype=np.int32, count=5)  # header
        stream = np.fromfile(f, dtype=np.float32)

    ptr = 0
    out = {k: v.clone() for k, v in state_dict.items()}

    def take(key):
        nonlocal ptr
        n = out[key].numel()
        chunk = stream[ptr:ptr + n]
        if chunk.size != n:
            raise ValueError(f"weights file exhausted at {ptr} (+{n}/{stream.size})")
        ptr += n
        out[key] = torch.from_numpy(chunk.copy()).reshape(out[key].shape)

    for prefix, conv_bn in _conv_bn_order(out, explicit_order):
        if not conv_bn:
            if f"{prefix}.bias" in out:
                take(f"{prefix}.bias")
            take(f"{prefix}.weight")
            continue
        for leaf in ("bias", "weight", "running_mean", "running_var"):
            take(f"{prefix}.bn.{leaf}")
        take(f"{prefix}.conv.weight")
    return out, ptr


def strip_module_prefix(state_dict: dict) -> dict:
    """DDP ``module.`` prefix strip (initialize.py:88-95)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


# ------------------------------------------------------------------ #
# torchvision <-> port key tables
# ------------------------------------------------------------------ #

def _conv(src: str, dst: str):
    return [(f"{src}.weight", f"{dst}.weight", None), (f"{src}.bias", f"{dst}.bias", None)]


def _bn(src: str, dst: str):
    return [(f"{src}.{leaf}", f"{dst}.{leaf}", None) for leaf in _BN]


def resnet_table(keys, layers=(3, 4, 6, 3), src: str = "", dst: str = ""):
    """torchvision ResNet (conv1/bn1, layer{s}.{i}.conv{1..3}/bn{1..3},
    .downsample.{0,1}) -> the port's ResNet (conv1/bn1,
    layer{s}_block{i}.conv{1..3}/bn{1..3}, down_conv/down_bn; the batch
    norms frozen)."""
    table = [(f"{src}conv1.weight", f"{dst}conv1.weight", None)] + _bn(f"{src}bn1", f"{dst}bn1")
    for stage, blocks in enumerate(layers):
        for b in range(blocks):
            t, o = f"{src}layer{stage + 1}.{b}", f"{dst}layer{stage + 1}_block{b}"
            for ci in (1, 2, 3):
                if f"{t}.conv{ci}.weight" in keys:
                    table.append((f"{t}.conv{ci}.weight", f"{o}.conv{ci}.weight", None))
                    table += _bn(f"{t}.bn{ci}", f"{o}.bn{ci}")
            if f"{t}.downsample.0.weight" in keys:
                table.append((f"{t}.downsample.0.weight", f"{o}.down_conv.weight", None))
                table += _bn(f"{t}.downsample.1", f"{o}.down_bn")
    return table


def _fpn_table(n_levels: int, p6p7: bool = False):
    table = []
    for i in range(n_levels):
        table += _conv(f"backbone.fpn.inner_blocks.{i}", f"backbone.fpn.inner{i}")
        table += _conv(f"backbone.fpn.layer_blocks.{i}", f"backbone.fpn.layer{i}")
    if p6p7:
        for p in ("p6", "p7"):
            table += _conv(f"backbone.fpn.extra_blocks.{p}", f"backbone.fpn.{p}")
    return table


def fasterrcnn_table(keys, layers=(3, 4, 6, 3), with_mask: bool = False,
                     with_keypoints: bool = False):
    """torchvision FasterRCNN / MaskRCNN / KeypointRCNN (the layout of
    `tvision/frcnn.py:302-376`'s pretrained loaders) -> the port's models:
    backbone.body (ResNet, FrozenBN), backbone.fpn, rpn.head,
    roi_heads.box_head / box_predictor and the mask / keypoint branches."""
    table = resnet_table(keys, layers, "backbone.body.", "backbone.resnet.") + _fpn_table(4)
    for name in ("conv", "cls_logits", "bbox_pred"):
        table += _conv(f"rpn.head.{name}", f"rpn_head.{name}")
    table += [("roi_heads.box_head.fc6.weight", "box_head.fc6.weight", "fc6"),
              ("roi_heads.box_head.fc6.bias", "box_head.fc6.bias", None)]
    table += _conv("roi_heads.box_head.fc7", "box_head.fc7")
    for name in ("cls_score", "bbox_pred"):
        table += _conv(f"roi_heads.box_predictor.{name}", f"box_predictor.{name}")
    if with_mask:
        for i in (1, 2, 3, 4):
            table += _conv(f"roi_heads.mask_head.mask_fcn{i}", f"mask_head.mask_fcn{i}")
        # ConvTranspose2d [in, out, kh, kw] in both
        for name in ("conv5_mask", "mask_fcn_logits"):
            table += _conv(f"roi_heads.mask_predictor.{name}", f"mask_predictor.{name}")
    if with_keypoints:
        n = len([k for k in keys if k.startswith("roi_heads.keypoint_head.kps_fcn")
                 and k.endswith(".weight")])
        for i in range(1, n + 1):
            table += _conv(f"roi_heads.keypoint_head.kps_fcn{i}", f"kp_head.kps_fcn{i}")
        table += _conv("roi_heads.keypoint_predictor.kps_score_lowres",
                       "kp_predictor.kps_score_lowres")
    return table


def retinanet_table(keys, layers=(3, 4, 6, 3)):
    """torchvision RetinaNet (tvision/retinanet.py: P3..P7 via
    LastLevelP6P7, the shared 4-conv towers) -> the port's RetinaNet."""
    table = resnet_table(keys, layers, "backbone.body.", "backbone.resnet.")
    table += _fpn_table(3, p6p7=True)
    for i in range(4):
        table += _conv(f"head.classification_head.conv.{2 * i}", f"head.cls_conv{i}")
        table += _conv(f"head.regression_head.conv.{2 * i}", f"head.reg_conv{i}")
    table += _conv("head.classification_head.cls_logits", "head.cls_logits")
    table += _conv("head.regression_head.bbox_reg", "head.bbox_reg")
    return table


# VGG features indices (cfg-D): convs at 0,2 / 5,7 / 10,12,14 / 17,19,21;
# extra.0 wraps maxpool4 + conv5_x + the atrous fc6/fc7; extra.1-4 are the
# conv8..conv11 pairs (tvision/ssd.py:434-541)
_SSD_VGG = {
    "conv1_1": "features.0", "conv1_2": "features.2",
    "conv2_1": "features.5", "conv2_2": "features.7",
    "conv3_1": "features.10", "conv3_2": "features.12", "conv3_3": "features.14",
    "conv4_1": "features.17", "conv4_2": "features.19", "conv4_3": "features.21",
    "conv5_0": "extra.0.1", "conv5_1": "extra.0.3", "conv5_2": "extra.0.5",
    "conv6": "extra.0.7.1", "conv7": "extra.0.7.3",
    "conv8_1": "extra.1.0", "conv8_2": "extra.1.2",
    "conv9_1": "extra.2.0", "conv9_2": "extra.2.2",
    "conv10_1": "extra.3.0", "conv10_2": "extra.3.2",
    "conv11_1": "extra.4.0", "conv11_2": "extra.4.2",
}


def ssd_table():
    """torchvision SSD300-VGG16 (SSDFeatureExtractorVGG + SSDHead) -> the
    port's SSD300."""
    table = [("backbone.scale_weight", "backbone.scale_weight", None)]
    for ours, theirs in _SSD_VGG.items():
        table += _conv(f"backbone.{theirs}", f"backbone.{ours}")
    for i in range(6):
        table += _conv(f"head.classification_head.module_list.{i}", f"head.cls{i}")
        table += _conv(f"head.regression_head.module_list.{i}", f"head.reg{i}")
    return table


def _fc6_to_port(w: torch.Tensor, channels: int, pool: int = 7) -> torch.Tensor:
    return w.reshape(-1, channels, pool, pool).permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def _fc6_to_torchvision(w: torch.Tensor, channels: int, pool: int = 7) -> torch.Tensor:
    return w.reshape(-1, pool, pool, channels).permute(0, 3, 1, 2).reshape(w.shape[0], -1)


def _pool_channels(state_dict: dict, key: str):
    return state_dict[key].shape[0] if key in state_dict else None


def _apply(table, state_dict: dict, channels) -> dict:
    out = {}
    for src, dst, kind in table:
        t = torch.as_tensor(np.asarray(state_dict[src]), dtype=torch.float32)
        out[dst] = _fc6_to_port(t, channels) if kind == "fc6" else t.clone()
    return out


def torch_fasterrcnn_to_port(state_dict: dict, layers=(3, 4, 6, 3), with_mask: bool = False,
                             with_keypoints: bool = False) -> dict:
    """A torchvision FasterRCNN / MaskRCNN / KeypointRCNN state dict -> a
    state dict for the port's ``FasterRCNN`` / ``MaskRCNN`` /
    ``KeypointRCNN``."""
    sd = strip_module_prefix(state_dict)
    return _apply(fasterrcnn_table(sd, layers, with_mask, with_keypoints), sd,
                  _pool_channels(sd, "backbone.fpn.inner_blocks.0.bias"))


def torch_retinanet_to_port(state_dict: dict, layers=(3, 4, 6, 3)) -> dict:
    """A torchvision RetinaNet state dict -> a state dict for the port's
    ``RetinaNet``."""
    sd = strip_module_prefix(state_dict)
    return _apply(retinanet_table(sd, layers), sd, None)


def torch_resnet_to_port(state_dict: dict, layers=(3, 4, 6, 3)) -> dict:
    """A torchvision ResNet state dict (the pretrained backbones of
    utilities/resnet.py) -> a state dict for the port's ``ResNet``."""
    sd = strip_module_prefix(state_dict)
    return _apply(resnet_table(sd, layers), sd, None)


def torch_ssd_to_port(state_dict: dict) -> dict:
    """A torchvision SSD300-VGG16 state dict -> a state dict for the port's
    ``SSD300``."""
    sd = strip_module_prefix(state_dict)
    return _apply(ssd_table(), sd, None)


def export_to_torchvision(table, port_state: dict, template_sd: dict) -> dict:
    """The inverse of a converter: each port tensor of ``table`` back to its
    torchvision key and layout; the template's other keys
    (num_batches_tracked etc.) keep their values."""
    out = {k: torch.as_tensor(np.asarray(v)).clone() for k, v in template_sd.items()}
    channels = _pool_channels(template_sd, "backbone.fpn.inner_blocks.0.bias")
    for src, dst, kind in table:
        t = port_state[dst].detach().cpu().float()
        out[src] = _fc6_to_torchvision(t, channels) if kind == "fc6" else t.clone()
    return out


def port_fasterrcnn_to_torch(port_state: dict, template_sd: dict, layers=(3, 4, 6, 3),
                             with_mask: bool = False, with_keypoints: bool = False) -> dict:
    """The port's trained FasterRCNN / MaskRCNN / KeypointRCNN state dict ->
    a torchvision state dict shaped like ``template_sd``."""
    return export_to_torchvision(fasterrcnn_table(template_sd, layers, with_mask,
                                                  with_keypoints), port_state, template_sd)


def port_retinanet_to_torch(port_state: dict, template_sd: dict, layers=(3, 4, 6, 3)) -> dict:
    """The port's RetinaNet state dict -> a torchvision state dict."""
    return export_to_torchvision(retinanet_table(template_sd, layers), port_state,
                                 template_sd)


@torch.no_grad()
def overwrite_eps(model: nn.Module, eps: float = 0.0, module_eps: float = 1e-5) -> nn.Module:
    """torchvision ``overwrite_eps(model, 0.0)``
    (torchvision_models/tvision/frcnn.py:302-376: legacy pretrained
    detection weights whose FrozenBatchNorm2d statistics were made with
    eps=0): the port's ``FrozenBatchNorm`` keeps eps at 1e-5, so the
    difference goes into ``running_var`` (var' + module_eps == var + eps).
    In place on every FrozenBatchNorm of ``model``; returns it."""
    for m in model.modules():
        if isinstance(m, FrozenBatchNorm):
            m.running_var.add_(eps - module_eps)
    return model
