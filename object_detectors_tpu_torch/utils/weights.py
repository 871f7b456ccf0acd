"""Flax variables -> state dicts for the port's models.

Takes nested dicts of numpy arrays (the collections as Flax stores them),
so neither flax nor msgpack is needed. The port's submodules carry the Flax
module names, so each leaf maps by its path: conv ``kernel`` HWIO ->
``weight`` OIHW, Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in],
``bias`` -> ``bias``; for YOLO, batch norm ``scale`` / ``bias`` ->
``weight`` / ``bias`` and ``batch_stats`` ``mean`` / ``var`` ->
``running_mean`` / ``running_var``; for the ResNet-FPN detectors, the
``frozen`` collection's leaves are the FrozenBatchNorm buffers of the same
names; a ResNet with trainable batch norm (``norm="bn"``) maps its ``scale``
/ ``bias`` and ``batch_stats`` as YOLO's.

A Flax ``ConvTranspose`` correlates without flipping its kernel, so its
(kh, kw, in, out) kernel becomes a ``ConvTranspose2d`` weight [in, out, kh,
kw] flipped in both spatial axes. A bare parameter (SSD's
``scale_weight``) keeps its name. Any other leaf raises.
"""

from __future__ import annotations

import numpy as np
import torch

_BN_PARAM = {"scale": "weight", "bias": "bias"}
_BN_STAT = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_yolo_to_torch(params, batch_stats) -> dict[str, torch.Tensor]:
    """Flax ``YoloHead`` variables -> a state dict for ``models.yolo.YoloHead``,
    the neck's SPP bottlenecks, FPN and ``fpn_proj1`` included (convs with
    bias, mapped by path like every other conv)."""
    state = {}
    for path, value in _leaves(params):
        *mod, leaf = path
        arr = np.asarray(value, np.float32)
        if mod[-1] == "bn":
            name = _BN_PARAM[leaf]
        elif leaf == "kernel":
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "bias":
            name = "bias"
        else:
            raise KeyError(f"unexpected Flax parameter {'/'.join(path)}")
        state[".".join(mod + [name])] = torch.from_numpy(np.array(arr))
    for path, value in _leaves(batch_stats):
        *mod, leaf = path
        state[".".join(mod + [_BN_STAT[leaf]])] = torch.from_numpy(
            np.array(value, np.float32))
        if leaf == "mean":
            state[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
    return state


def flax_class_attention_to_torch(params) -> dict[str, torch.Tensor]:
    """Flax ``ClassAttention`` parameters (Dense ``fc1``, ``fc2``) -> a state
    dict for ``models.common.ClassAttention``."""
    return _flax_frozen_bn_to_torch(params, {})


def flax_frcnn_to_torch(params, frozen) -> dict[str, torch.Tensor]:
    """Flax ``FasterRCNN`` variables -> a state dict for
    ``models.faster_rcnn.FasterRCNN`` (the ``fc6`` input is already in the
    port's (y, x, c) order, so it needs no permutation)."""
    return _flax_frozen_bn_to_torch(params, frozen)


def flax_retinanet_to_torch(params, frozen) -> dict[str, torch.Tensor]:
    """Flax ``RetinaNet`` variables (the head's unpacked parameter tree, which
    the packed head shares) -> a state dict for
    ``models.retinanet.RetinaNet``."""
    return _flax_frozen_bn_to_torch(params, frozen)


def flax_maskrcnn_to_torch(params, frozen) -> dict[str, torch.Tensor]:
    """Flax ``MaskRCNN`` variables -> a state dict for
    ``models.mask_rcnn.MaskRCNN`` (``conv5_mask`` is a transposed conv)."""
    return _flax_frozen_bn_to_torch(params, frozen, transposed=("conv5_mask",))


def flax_kprcnn_to_torch(params, frozen) -> dict[str, torch.Tensor]:
    """Flax ``KeypointRCNN`` variables -> a state dict for
    ``models.keypoint_rcnn.KeypointRCNN`` (``kps_score_lowres`` is a
    transposed conv)."""
    return _flax_frozen_bn_to_torch(params, frozen, transposed=("kps_score_lowres",))


def flax_ssd_to_torch(params) -> dict[str, torch.Tensor]:
    """Flax ``SSD300`` parameters -> a state dict for ``models.ssd.SSD300``
    (the VGG's ``scale_weight`` by its name)."""
    return _flax_frozen_bn_to_torch(params, {}, bare=("scale_weight",))


def flax_resnet_to_torch(params, frozen=None, batch_stats=None) -> dict[str, torch.Tensor]:
    """Flax ``ResNet`` (or ``BackboneWithFPN``) variables of either block and
    either norm -> a state dict for ``models.resnet.ResNet`` (or
    ``BackboneWithFPN``): convs by path; with ``norm="frozen"`` the
    ``frozen`` collection's buffers, with ``norm="bn"`` the batch norms'
    ``scale`` / ``bias`` parameters and their ``batch_stats``."""
    state = _flax_frozen_bn_to_torch(params, frozen or {}, bare=("scale",))
    for name in [k for k in state if k.endswith(".scale")]:
        state[name[:-len("scale")] + "weight"] = state.pop(name)
    for path, value in _leaves(batch_stats or {}):
        *mod, leaf = path
        state[".".join(mod + [_BN_STAT[leaf]])] = torch.from_numpy(np.array(value, np.float32))
        if leaf == "mean":
            state[".".join(mod + ["num_batches_tracked"])] = torch.tensor(0)
    return state


def _flax_frozen_bn_to_torch(params, frozen, transposed=(), bare=()) -> dict[str, torch.Tensor]:
    """Convs and dense layers by path, the modules named in ``transposed``
    as transposed convs, the leaves named in ``bare`` as they are; the
    ``frozen`` collection's leaves are the FrozenBatchNorm buffers of the
    same names."""
    state = {}
    for path, value in _leaves(params):
        *mod, leaf = path
        arr = np.asarray(value, np.float32)
        if leaf == "kernel" and mod[-1] in transposed:
            name, arr = "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == "kernel":
            name, arr = "weight", arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf == "bias" or leaf in bare:
            name = leaf
        else:
            raise KeyError(f"unexpected Flax parameter {'/'.join(path)}")
        state[".".join(mod + [name])] = torch.from_numpy(np.array(arr))
    for path, value in _leaves(frozen):
        state[".".join(path)] = torch.from_numpy(np.array(value, np.float32))
    return state
