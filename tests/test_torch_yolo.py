"""The port's YOLOv3 network and decode (object_detectors_tpu_torch/models)
against the Flax YoloHead and yolo_criterion, with the same weights moved
by utils/weights.py: the default head, the SPP and FPN necks, Darknet-21,
and the blocks off the main path (max_pool_same, ClassAttention, the FPN's
P6 from C5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.models import common as jax_common
from object_detectors_tpu.models import darknet as jax_darknet
from object_detectors_tpu.models import fpn as jax_fpn
from object_detectors_tpu.models import yolo_criterion as jax_yc
from object_detectors_tpu.models.yolo import YoloHead as FlaxYoloHead
from object_detectors_tpu_torch.models import common as C
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.models.darknet import darknet21
from object_detectors_tpu_torch.models.fpn import FeaturePyramidNetwork
from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
from object_detectors_tpu_torch.utils.weights import (
    flax_class_attention_to_torch, flax_retinanet_to_torch, flax_yolo_to_torch,
)

LAYERS = (1, 1, 1, 1, 1)
NUM_CLASSES = 4


def randomize_bn(variables, seed):
    """Every batch norm's scale/bias/mean/var drawn at random (the init
    values (1, 0, 0, 1) would hide a swapped mapping), and the neck's conv
    biases too (zero at init)."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = path[-1].key
        if path[-2].key != "bn":
            if path[1].key == "neck" and name == "bias":
                return rng.uniform(-0.2, 0.2, x.shape).astype(np.float32)
            return np.asarray(x)
        shape = x.shape
        if name == "scale":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.uniform(-0.2, 0.2, shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)  # var

    return jax.tree_util.tree_map_with_path(
        draw, jax.tree_util.tree_map(np.asarray, dict(variables)))


def randomized_flax_variables(img_size, seed=0, **head):
    """A Flax YoloHead (``head``: its neck options) and its variables with
    ``randomize_bn``."""
    model = FlaxYoloHead(num_classes=NUM_CLASSES, backbone_layers=LAYERS, **head)
    v = model.init(jax.random.key(seed), jnp.zeros((1, img_size, img_size, 3)),
                   train=False)
    return model, randomize_bn(v, seed)


@pytest.fixture(scope="module")
def flax_yolo():
    return randomized_flax_variables(96)


def torch_model(variables, dtype=torch.float32, **head):
    model = YoloHead(NUM_CLASSES, 3, LAYERS, dtype=dtype, **head)
    model.load_state_dict(flax_yolo_to_torch(variables["params"],
                                             variables["batch_stats"]))
    return model.eval()


def test_converter_fills_every_tensor_of_the_model(flax_yolo):
    _, variables = flax_yolo
    state = flax_yolo_to_torch(variables["params"], variables["batch_stats"])
    model = YoloHead(NUM_CLASSES, 3, LAYERS)
    assert set(state) == set(model.state_dict())
    conv = variables["params"]["backbone"]["stem"]["conv"]["kernel"]  # HWIO
    np.testing.assert_array_equal(state["backbone.stem.conv.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["embedding2.cbl1.bn.running_var"].numpy(),
        variables["batch_stats"]["embedding2"]["cbl1"]["bn"]["var"])


def test_yolo_head_raw_outputs_match_flax(flax_yolo):
    flax_model, variables = flax_yolo
    x = np.random.RandomState(1).randn(2, 96, 96, 3).astype(np.float32)
    ref = flax_model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = torch_model(variables)(torch.from_numpy(x))
    assert len(out) == 3
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape  # NHWC at the boundary
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_decode_matches_jax():
    cfg_j = jax_yc.YoloLossConfig(num_classes=NUM_CLASSES, img_size=128)
    cfg_t = YC.YoloLossConfig(num_classes=NUM_CLASSES, img_size=128)
    grids = (4, 8, 16)
    pj, gj = jax_yc.make_priors(cfg_j, grids)
    pt, gt = YC.make_priors(cfg_t, grids)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))

    rng = np.random.RandomState(2)
    maps = [rng.randn(2, g, g, 3 * (5 + NUM_CLASSES)).astype(np.float32) for g in grids]
    raw_j = jax_yc.flatten_raw_outputs([jnp.asarray(m) for m in maps], NUM_CLASSES, 3)
    raw_t = YC.flatten_raw_outputs([torch.from_numpy(m) for m in maps], NUM_CLASSES, 3)
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j))
    dec_j = jax_yc.yolo_decode(raw_j, pj, gj, cfg_j)
    dec_t = YC.yolo_decode(raw_t, pt, gt, cfg_t)
    np.testing.assert_allclose(dec_t.numpy(), np.asarray(dec_j), rtol=1e-5, atol=1e-5)


def test_init_is_seeded_and_device_independent():
    a = init_yolo_(YoloHead(NUM_CLASSES, 3, LAYERS), seed=3).state_dict()
    b = init_yolo_(YoloHead(NUM_CLASSES, 3, LAYERS), seed=3).state_dict()
    c = init_yolo_(YoloHead(NUM_CLASSES, 3, LAYERS), seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.stem.conv.weight"], c["backbone.stem.conv.weight"])


def test_bf16_forward_keeps_f32_params():
    dtype = torch.bfloat16
    model = init_yolo_(YoloHead(NUM_CLASSES, 3, LAYERS, dtype=dtype)).eval()
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 64, 64, 3).astype(np.float32))
    with torch.no_grad():
        out = model(x)
    assert all(o.dtype == dtype and torch.isfinite(o.float()).all() for o in out)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("head", [
    dict(use_spp=True),
    dict(use_fpn=True),
    dict(use_spp=True, use_fpn=True, pyramids=((3,), (5, 9), (5, 9, 13))),
])
def test_yolo_necks_match_flax(head):
    """SPP (max pools up to 13 wide on a 2x2 C5, per-scale pyramids) and the
    FPN neck with fpn_proj1, weights through flax_yolo_to_torch."""
    flax_model, variables = randomized_flax_variables(64, seed=3, **head)
    state = flax_yolo_to_torch(variables["params"], variables["batch_stats"])
    assert set(state) == set(YoloHead(NUM_CLASSES, 3, LAYERS, **head).state_dict())
    assert any(k.startswith("neck.") for k in state)
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    ref = flax_model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = torch_model(variables, **head)(torch.from_numpy(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_darknet21_matches_flax():
    flax_net = jax_darknet.darknet21()
    x = np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32)
    v = randomize_bn(flax_net.init(jax.random.key(5), jnp.asarray(x), train=False), 5)
    ref = flax_net.apply(v, jnp.asarray(x), train=False)
    net = darknet21()
    assert net.layers == (1, 1, 2, 2, 1)
    net.load_state_dict(flax_yolo_to_torch(v["params"], v["batch_stats"]))
    with torch.no_grad():
        out = net.eval()(_nchw(x))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window,stride", [(1, 2), (2, 1), (3, 2), (5, 1), (13, 1)])
def test_max_pool_same_matches_jax(window, stride):
    x = np.random.RandomState(window).randn(2, 7, 9, 3).astype(np.float32)
    ref = jax_common.max_pool_same(jnp.asarray(x), window, stride)
    out = C.max_pool_same(_nchw(x), window, stride).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_class_attention_matches_flax():
    flax_ca = jax_common.ClassAttention(num_classes=7, reduction_ratio=4)
    x = np.random.RandomState(6).randn(2, 3, 3, 3, 7).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, flax_ca.init(jax.random.key(6), x)["params"])
    rng = np.random.RandomState(7)
    for fc in params.values():  # biases are zero at init
        fc["bias"] = rng.uniform(-0.5, 0.5, fc["bias"].shape).astype(np.float32)
    ref = flax_ca.apply({"params": params}, jnp.asarray(x))
    ca = C.ClassAttention(7, 4)
    ca.load_state_dict(flax_class_attention_to_torch(params))
    with torch.no_grad():
        out = ca(torch.from_numpy(x))
    assert out.shape == (2, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_fpn_p6p7_from_c5_matches_flax():
    """RetinaNet's P6/P7 taken from C5 (the paper's variant) rather than P5."""
    rng = np.random.RandomState(8)
    feats = [rng.randn(2, s, s, c).astype(np.float32) for s, c in ((16, 16), (8, 32), (4, 64))]
    flax_fpn = jax_fpn.FeaturePyramidNetwork(out_channels=8, extra_blocks="p6p7",
                                             p6p7_in_from_c5=True)
    jfeats = [jnp.asarray(f) for f in feats]
    params = jax.tree_util.tree_map(
        np.asarray, flax_fpn.init(jax.random.key(8), jfeats, c5=jfeats[-1])["params"])
    ref = flax_fpn.apply({"params": params}, jfeats, c5=jfeats[-1])
    fpn = FeaturePyramidNetwork([16, 32, 64], 8, "p6p7", p6p7_in_from_c5=True)
    fpn.load_state_dict(flax_retinanet_to_torch(params, {}))
    assert fpn.p6.in_channels == 64
    with torch.no_grad():
        out = fpn([_nchw(f) for f in feats], c5=_nchw(feats[-1]))
        with pytest.raises(ValueError, match="c5"):
            fpn([_nchw(f) for f in feats])
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)
