"""The port's weight import (object_detectors_tpu_torch/utils/weights_io.py)
against the JAX package's ``utils/weights_io.py`` on the CPU, on synthetic
inputs (no download).

* a synthetic Darknet ``.weights`` file loads into the tiny YOLO through
  JAX (``load_darknet_weights``, then ``flax_yolo_to_torch``) and through
  the port into bitwise-equal state dicts, whole-model and backbone-only;
  a short file raises the same error;
* each torchvision loader (Faster / Mask / Keypoint R-CNN, RetinaNet,
  ResNet, SSD300) equals JAX's converter followed by the port's
  ``flax_*_to_torch``, bit for bit, on a synthetic torchvision-keyed state
  dict shaped like the port's model, and the result loads strictly;
* the export to torchvision round-trips and equals JAX's inverse;
* ``overwrite_eps`` equals JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.utils import weights_io as JW
from object_detectors_tpu_torch import detection_main as DM
from object_detectors_tpu_torch.models.darknet import DarkNet
from object_detectors_tpu_torch.models.resnet import ResNet
from object_detectors_tpu_torch.models.yolo import YoloHead
from object_detectors_tpu_torch.utils import weights as W
from object_detectors_tpu_torch.utils import weights_io as WI
from torch_threads import share_cores  # noqa: F401 (autouse)

LAYERS = (1, 1, 1, 1, 1)


def _write_weights(path, n, seed=0):
    with open(path, "wb") as f:
        np.array([0, 2, 0, 0, 0], np.int32).tofile(f)
        np.random.RandomState(seed).randn(n).astype(np.float32).tofile(f)


def _flax_zeros(model, size=64):
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, size, size, 3)),
                                               train=False))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.fixture(scope="module")
def yolo_zeros():
    from object_detectors_tpu.models.yolo import YoloHead as JYoloHead
    return _flax_zeros(JYoloHead(num_classes=4, backbone_layers=LAYERS))


def test_darknet_weights_load_as_jax(tmp_path, yolo_zeros):
    order = JW.yolo_head_order(LAYERS)
    model = YoloHead(4, backbone_layers=LAYERS)
    sd = model.state_dict()
    n = sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    path = str(tmp_path / "yolo.weights")
    _write_weights(path, n)
    ours, used = WI.load_darknet_weights(sd, path, WI.yolo_head_order(LAYERS))
    p, s, jused = JW.load_darknet_weights(yolo_zeros["params"], yolo_zeros["batch_stats"], path,
                                          order)
    ref = W.flax_yolo_to_torch(p, s)
    assert used == jused == n and ours.keys() == ref.keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k].to(ours[k].dtype)), k
    model.load_state_dict(ours)
    # the port's own module order is the reference's registration order
    assert [p for p, _ in WI._conv_bn_order(sd)] == [".".join(p) for p in order]
    assert WI.yolo_head_order(LAYERS) == order
    # a short file: the same error
    _write_weights(path, n - 3)
    with pytest.raises(ValueError) as ours_err:
        WI.load_darknet_weights(sd, path, WI.yolo_head_order(LAYERS))
    with pytest.raises(ValueError) as ref_err:
        JW.load_darknet_weights(yolo_zeros["params"], yolo_zeros["batch_stats"], path, order)
    assert str(ours_err.value) == str(ref_err.value)


def test_backbone_only_darknet_weights_load_as_jax(tmp_path, yolo_zeros):
    bb = DarkNet(LAYERS)
    sd = bb.state_dict()
    n = sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    path = str(tmp_path / "darknet.conv.weights")
    _write_weights(path, n + 11, seed=1)  # trailing floats are left unread
    ours, used = WI.load_darknet_weights(sd, path, WI.darknet_block_order(LAYERS))
    p, s, jused = JW.load_darknet_weights(yolo_zeros["params"]["backbone"],
                                          yolo_zeros["batch_stats"]["backbone"], path,
                                          JW.darknet_block_order(LAYERS))
    ref = W.flax_yolo_to_torch(p, s)
    assert used == jused == n
    for k in ref:
        assert torch.equal(ours[k], ref[k].to(ours[k].dtype)), k


def _torchvision_like(table, port_sd, seed=0):
    """A synthetic torchvision-keyed state dict: every source key of
    ``table`` with its port tensor's shape, seeded values (variances
    positive)."""
    rng = np.random.RandomState(seed)
    out = {}
    for src, dst, _ in table:
        a = rng.randn(*port_sd[dst].shape).astype(np.float32)
        out[src] = np.abs(a) + 0.5 if src.endswith("running_var") else a
    out["backbone.body.bn1.num_batches_tracked"] = np.zeros((), np.int64)
    return out


def _resnet_keys(layers, prefix="backbone.body."):
    """The torchvision keys that tell a converter which convs a ResNet has."""
    return ({f"{prefix}layer{s + 1}.{b}.conv{c}.weight" for s, n in enumerate(layers)
             for b in range(n) for c in (1, 2, 3)}
            | {f"{prefix}layer{s + 1}.0.downsample.0.weight" for s in range(len(layers))})


def _two_stage(name):
    return DM.ModelAdapter(name, 5, 64, resnet_layers=(1, 1, 1, 1), small=True,
                           device="cpu").model


CASES = {
    "fasterrcnn": (lambda: _two_stage("fasterrcnn_resnet50_fpn"), {}, W.flax_frcnn_to_torch),
    "maskrcnn": (lambda: _two_stage("maskrcnn_resnet50_fpn"), {"with_mask": True},
                 W.flax_maskrcnn_to_torch),
    "keypointrcnn": (lambda: _two_stage("keypointrcnn_resnet50_fpn"),
                     {"with_keypoints": True}, W.flax_kprcnn_to_torch),
}


def _assert_same(ours: dict, ref: dict):
    assert ours.keys() == ref.keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_rcnn_loaders_and_export_are_jax_s(name):
    make, kw, flax_to_torch = CASES[name]
    model = make()
    table = WI.fasterrcnn_table(
        _resnet_keys((1, 1, 1, 1)) | {"roi_heads.keypoint_head.kps_fcn1.weight",
                                      "roi_heads.keypoint_head.kps_fcn2.weight"},
        (1, 1, 1, 1), **kw)
    sd = _torchvision_like(table, model.state_dict())
    ours = WI.torch_fasterrcnn_to_port(sd, (1, 1, 1, 1), **kw)
    v = JW.torch_fasterrcnn_to_flax(sd, (1, 1, 1, 1), **kw)
    _assert_same(ours, flax_to_torch(v["params"], v["frozen"]))
    model.load_state_dict(ours)  # strict: every tensor of the model
    back = WI.port_fasterrcnn_to_torch(model.state_dict(), sd, (1, 1, 1, 1), **kw)
    jback = JW.flax_fasterrcnn_to_torch(v, sd, (1, 1, 1, 1), **kw)
    assert back.keys() == sd.keys() == jback.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]), err_msg=k)
    # DDP checkpoints carry a module. prefix
    _assert_same(WI.torch_fasterrcnn_to_port({f"module.{k}": a for k, a in sd.items()},
                                             (1, 1, 1, 1), **kw), ours)


def test_retinanet_loader_and_export_are_jax_s():
    model = DM.ModelAdapter("retinanet_resnet50_fpn", 5, 64, resnet_layers=(1, 1, 1, 1),
                            device="cpu").model
    sd = _torchvision_like(WI.retinanet_table(_resnet_keys((1, 1, 1, 1)), (1, 1, 1, 1)),
                           model.state_dict(), 1)
    ours = WI.torch_retinanet_to_port(sd, (1, 1, 1, 1))
    v = JW.torch_retinanet_to_flax(sd, (1, 1, 1, 1))
    _assert_same(ours, W.flax_retinanet_to_torch(v["params"], v["frozen"]))
    model.load_state_dict(ours)
    back = WI.port_retinanet_to_torch(model.state_dict(), sd, (1, 1, 1, 1))
    jback = JW.flax_retinanet_to_torch(v, sd, (1, 1, 1, 1))
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]), err_msg=k)


def test_resnet_and_ssd_loaders_are_jax_s():
    resnet = ResNet((1, 2, 1, 1))
    keys = _resnet_keys((1, 2, 1, 1), prefix="")
    sd = _torchvision_like(WI.resnet_table(keys, (1, 2, 1, 1)), resnet.state_dict(), 2)
    sd.pop("backbone.body.bn1.num_batches_tracked")
    ours = WI.torch_resnet_to_port(sd, (1, 2, 1, 1))
    params, frozen = JW.torch_resnet_to_flax(sd, (1, 2, 1, 1))
    _assert_same(ours, W.flax_frcnn_to_torch(params, frozen))
    resnet.load_state_dict(ours)

    ssd = DM.ModelAdapter("ssd300_vgg16", 5, 300, device="cpu").model
    sd = _torchvision_like(WI.ssd_table(), ssd.state_dict(), 3)
    ours = WI.torch_ssd_to_port(sd)
    _assert_same(ours, W.flax_ssd_to_torch(JW.torch_ssd_to_flax(sd)["params"]))
    ssd.load_state_dict(ours)


def test_strip_module_prefix_and_overwrite_eps_are_jax_s():
    sd = {"module.a": 1, "b": 2, "x.module.c": 3}
    assert WI.strip_module_prefix(sd) == JW.strip_module_prefix(sd)
    model = _two_stage("fasterrcnn_resnet50_fpn")
    table = WI.fasterrcnn_table(_resnet_keys((1, 1, 1, 1)), (1, 1, 1, 1))
    sd = _torchvision_like(table, model.state_dict(), 4)
    v = JW.torch_fasterrcnn_to_flax(sd, (1, 1, 1, 1))
    model.load_state_dict(WI.torch_fasterrcnn_to_port(sd, (1, 1, 1, 1)))
    assert WI.overwrite_eps(model, eps=0.0) is model
    fixed = JW.overwrite_eps(v, eps=0.0)
    _assert_same(model.state_dict(), W.flax_frcnn_to_torch(fixed["params"], fixed["frozen"]))
