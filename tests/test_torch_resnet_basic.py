"""The port's ResNet-18 / BasicBlock with both norms, ``trainable_mask``,
``BoxCoder``, ``max_pool_3x3_s2`` and SPP without its bottleneck, against
the JAX package's on the CPU, weights carried across with
``utils/weights.py``.

Tolerances: C2-C5 of ResNet-18 at 64 px in f32 within 1e-4 (XLA and
PyTorch sum the convolutions in other orders); running statistics, masks
and the max pool bitwise; BoxCoder within 1e-5 relative and 1e-4 px; SPP
within 1e-4."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from object_detectors_tpu.models import common as JC
from object_detectors_tpu.models import resnet as JR
from object_detectors_tpu.models import yolo as JYH
from object_detectors_tpu.ops import boxes as JB
from object_detectors_tpu_torch.models import common as C
from object_detectors_tpu_torch.models import resnet as R
from object_detectors_tpu_torch.models.yolo import SPP
from object_detectors_tpu_torch.ops.boxes import BoxCoder
from object_detectors_tpu_torch.utils.weights import flax_resnet_to_torch

FEAT_ATOL = 1e-4


def randomized(variables, rng):
    """The norms' statistics and frozen buffers drawn away from the
    identity, so that the test sees them."""
    out = dict(variables)
    for coll in ("batch_stats", "frozen"):
        if coll in out:
            out[coll] = jax.tree_util.tree_map_with_path(
                lambda p, a: jnp.asarray(
                    rng.uniform(0.5, 1.5, a.shape) if p[-1].key in ("var", "running_var",
                                                                     "weight")
                    else rng.uniform(-0.1, 0.1, a.shape), jnp.float32), out[coll])
    return out


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("norm", ["frozen", "bn"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet18_features_match_jax(norm, train):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jax_model = JR.resnet18(norm=norm)
    variables = randomized(jax_model.init(jax.random.key(0), jnp.asarray(x)), rng)
    if train:
        ref, updates = jax_model.apply(variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
    else:
        ref, updates = jax_model.apply(variables, jnp.asarray(x), train=False), {}

    port = R.resnet18(norm=norm)
    port.load_state_dict(flax_resnet_to_torch(variables["params"], variables.get("frozen"),
                                              variables.get("batch_stats")))
    port.train(train)
    out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [o.shape[1] for o in out] == port.out_channels == [64, 128, 256, 512]
    for r, o in zip(ref, out):
        np.testing.assert_allclose(nhwc(o), np.asarray(r), rtol=0, atol=FEAT_ATOL)
    if norm == "bn":
        # JAX's _norm uses the running averages in training too: nothing moves
        stats = flax_resnet_to_torch({}, None, updates.get("batch_stats",
                                                           variables["batch_stats"]))
        buffers = dict(port.named_buffers())
        for name, value in stats.items():
            assert torch.equal(buffers[name], value), name
        assert isinstance(port.bn1, nn.BatchNorm2d) and port.bn1.weight.requires_grad


class _JaxDetector(fnn.Module):
    """A backbone (basic-block ResNet with batch norm, FPN) and a head, as
    a detector's parameter tree holds them."""

    def setup(self):
        self.backbone = JR.BackboneWithFPN(JR.ResNet((1, 1, 1, 1), "basic", "bn"),
                                           out_channels=16)
        self.head = fnn.Conv(4, (1, 1))

    def __call__(self, x):
        return self.head(self.backbone(x)[0])


class _Detector(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = R.BackboneWithFPN(R.ResNet((1, 1, 1, 1), block="basic", norm="bn"), 16)
        self.head = nn.Conv2d(16, 4, 1)


@pytest.fixture(scope="module")
def detector_params():
    return _JaxDetector().init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)))


@pytest.mark.parametrize("trainable_layers", range(6))
def test_trainable_mask_matches_jax(detector_params, trainable_layers):
    params = detector_params["params"]
    jax_mask = JR.trainable_mask(params, trainable_layers)
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    want = {".".join([p.key for p in path[:-1]] + [leaves[path[-1].key]]): bool(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax_mask)[0]}
    port = _Detector()
    port.load_state_dict(flax_resnet_to_torch(params, None, detector_params["batch_stats"]))
    assert R.trainable_mask(port, trainable_layers) == want
    mask = R.apply_trainable_mask(port, trainable_layers)
    assert {n: p.requires_grad for n, p in port.named_parameters()} == mask
    assert mask["head.weight"] and mask["backbone.resnet.layer4_block0.conv1.weight"] == (
        trainable_layers >= 1)
    assert mask["backbone.resnet.bn1.weight"] == (trainable_layers == 5)


def test_box_coder_matches_jax():
    rng = np.random.RandomState(3)
    xy = rng.rand(2, 50, 2) * 200
    props = np.concatenate([xy, xy + rng.rand(2, 50, 2) * 100 + 4], -1).astype(np.float32)
    xy = props[..., :2] + rng.randn(2, 50, 2) * 5
    gt = np.concatenate([xy, xy + rng.rand(2, 50, 2) * 100 + 4], -1).astype(np.float32)
    weights = (10.0, 10.0, 5.0, 5.0)
    jax_coder, coder = JB.BoxCoder(weights), BoxCoder(weights)
    codes = coder.encode(torch.from_numpy(gt), torch.from_numpy(props))
    np.testing.assert_allclose(codes.numpy(), np.asarray(jax_coder.encode(gt, props)),
                               rtol=1e-5, atol=1e-5)
    big = codes * 3  # some past the exp clip
    boxes = coder.decode(big, torch.from_numpy(props)).numpy()
    np.testing.assert_allclose(boxes, np.asarray(jax_coder.decode(big.numpy(), props)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(coder.decode(codes, torch.from_numpy(props)).numpy(), gt,
                               rtol=1e-5, atol=1e-3)
    assert coder.weights == jax_coder.weights
    assert coder.bbox_xform_clip == jax_coder.bbox_xform_clip


@pytest.mark.parametrize("hw", [(8, 8), (10, 6), (7, 9), (9, 8), (1, 1)])
def test_max_pool_3x3_s2_bitwise(hw):
    x = np.random.RandomState(4).randn(2, *hw, 5).astype(np.float32)
    x[0, 0, 0] = -np.inf  # a -inf input next to the padding
    ref = np.asarray(JC.max_pool_3x3_s2(jnp.asarray(x)))
    got = nhwc(C.max_pool_3x3_s2(torch.from_numpy(x).permute(0, 3, 1, 2)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bottleneck", [False, True])
def test_spp_bottleneck_flag_matches_jax(bottleneck):
    rng = np.random.RandomState(5)
    chans, sizes = (32, 16, 8), (2, 4, 8)
    feats = [rng.randn(1, s, s, c).astype(np.float32) for c, s in zip(chans, sizes)]
    pyramids = ((5, 9, 13), (5, 9), (5,))
    jax_spp = JYH.SPP(pyramids, bottleneck=bottleneck)
    variables = jax_spp.init(jax.random.key(1), tuple(jnp.asarray(f) for f in feats))
    ref = jax_spp.apply(variables, tuple(jnp.asarray(f) for f in feats))
    port = SPP(chans, pyramids, bottleneck=bottleneck)
    port.load_state_dict(flax_resnet_to_torch(variables["params"]))
    got = port(tuple(torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats))
    widths = [c if bottleneck or k == 0 else c * (1 + len(p))
              for k, (c, p) in enumerate(zip(chans, pyramids))]
    assert [g.shape[1] for g in got] == widths
    for r, g in zip(ref, got):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), rtol=0, atol=FEAT_ATOL)
