"""The port's RetinaNet inference path (object_detectors_tpu_torch) against the
JAX RetinaNet on a tiny config (ResNet (1, 1, 1, 1), 96 px, 5 classes: 1746
anchors, so the 2000-candidate cap is reached), with the same weights moved
by utils/weights.py: backbone and head in f32, the postprocess on seeded
bf16-valued logits with heavy ties for scalar and vector tfidf, and the
uint8 pipeline end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.kernels.preprocess import preprocess_images as jax_preprocess
from object_detectors_tpu.models import anchors as jax_anchors
from object_detectors_tpu.models import retinanet as JRN
from object_detectors_tpu_torch import pipeline as PL
from object_detectors_tpu_torch.models import anchors as A
from object_detectors_tpu_torch.models import retinanet as RN
from object_detectors_tpu_torch.utils.weights import flax_retinanet_to_torch

IMG = 96
NUM_CLASSES = 5
LAYERS = (1, 1, 1, 1)
CLS_SCALE = 60.0  # spreads the class logits around the 0.05 threshold


def _grids():
    return tuple(jax_anchors.fpn_grid_sizes((IMG, IMG)))


def _anchors() -> np.ndarray:
    sizes, ratios = jax_anchors.retinanet_anchor_config()
    return jax_anchors.grid_anchors((IMG, IMG), _grids(), sizes, ratios)


def _level_sizes():
    return tuple(h * w * 9 for h, w in _grids())


def _randomized_frozen(frozen, seed):
    rng = np.random.RandomState(seed)
    ranges = {"weight": (0.5, 1.5), "bias": (-0.2, 0.2), "running_mean": (-0.2, 0.2),
              "running_var": (0.5, 2.0)}
    return jax.tree_util.tree_map_with_path(
        lambda path, x: rng.uniform(*ranges[path[-1].key], x.shape).astype(np.float32),
        frozen)


def _torch_retinanet(params, frozen) -> RN.RetinaNet:
    model = RN.RetinaNet(NUM_CLASSES, LAYERS)
    model.load_state_dict(flax_retinanet_to_torch(params, frozen))  # strict
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    """JAX RetinaNet (f32, packed head), numpy variables with random frozen
    statistics and the class conv scaled, the port model with the same
    weights, and two normalized images."""
    model = JRN.RetinaNet(num_classes=NUM_CLASSES, resnet_layers=LAYERS)
    # the parameters do not depend on the image size; a jitted init at 32 px
    # is quicker than an eager one
    v = jax.jit(lambda key: model.init(key, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.key(0))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["frozen"] = _randomized_frozen(v["frozen"], 1)
    cls = v["params"]["head"]["cls_logits"]
    cls["kernel"] = cls["kernel"] * CLS_SCALE
    x = np.random.RandomState(2).randn(2, IMG, IMG, 3).astype(np.float32)
    return model, v, _torch_retinanet(v["params"], v["frozen"]), x


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def test_anchors_match_jax():
    assert A.retinanet_anchor_config() == jax_anchors.retinanet_anchor_config()
    for size in ((IMG, IMG), (320, 320), (640, 640), (72, 100)):
        assert A.fpn_grid_sizes(size) == jax_anchors.fpn_grid_sizes(size)
    sizes, ratios = A.retinanet_anchor_config()
    np.testing.assert_array_equal(
        A.grid_anchors((IMG, IMG), A.fpn_grid_sizes((IMG, IMG)), sizes, ratios), _anchors())
    assert sum(_level_sizes()) == 1746


def test_converter_loads_every_tensor(tiny):
    _, v, _, _ = tiny
    state = flax_retinanet_to_torch(v["params"], v["frozen"])
    model = RN.RetinaNet(NUM_CLASSES, LAYERS)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state, strict=True)


def _jax_features(model, v, x):
    return model.apply(v, jnp.asarray(x), method=lambda m, x: m.backbone(x, False))


def test_backbone_p3_to_p7_match_jax(tiny):
    model, v, port, x = tiny
    ref = _jax_features(model, v, x)
    with torch.no_grad():
        out = port.backbone(nchw(x).contiguous(memory_format=torch.channels_last))
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        o = o.permute(0, 2, 3, 1).numpy()
        assert o.shape == r.shape
        np.testing.assert_allclose(o, np.asarray(r), rtol=1e-4, atol=1e-4)


def test_head_matches_jax_packed_head(tiny):
    model, v, port, x = tiny
    feats = [np.asarray(f) for f in _jax_features(model, v, x)]
    cls_r, reg_r, sizes_r = model.apply(v, [jnp.asarray(f) for f in feats],
                                        method=lambda m, f: m.head(f))
    with torch.no_grad():
        cls, reg, sizes = port.head([nchw(f) for f in feats])
    assert sizes == tuple(sizes_r) == _level_sizes()
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_r), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(reg.numpy(), np.asarray(reg_r), rtol=1e-4, atol=1e-4)


def _tied_inputs(seed):
    """bf16-valued logits from a few values around logit(0.05) = -2.94, so
    ties are everywhere and a third or so of the pairs pass, and box
    deltas; the same bits for JAX and torch."""
    rng = np.random.RandomState(seed)
    total = sum(_level_sizes())
    logits = jnp.asarray(rng.randint(-40, 20, (2, total, NUM_CLASSES)) / 8, jnp.bfloat16)
    reg = jnp.asarray(rng.randn(2, total, 4).astype(np.float32) * 0.3, jnp.bfloat16)
    to_torch = [torch.from_numpy(np.asarray(a.view(jnp.uint16)).view(np.int16).copy())
                .view(torch.bfloat16) for a in (logits, reg)]
    return (logits, reg), to_torch


def _assert_detections_equal(out, ref, rtol=0.0):
    out = [t.numpy() for t in out]
    ref = [np.asarray(r) for r in ref]
    np.testing.assert_array_equal(out[3], ref[3])  # valid
    np.testing.assert_array_equal(out[2], ref[2])  # labels
    np.testing.assert_allclose(out[0], ref[0], rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(out[1], ref[1], rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("tfidf", [1.0, 0.8, "vector", "0-dim"])
@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_matches_jax_in_order(tfidf, seed):
    (logits, reg), (tl, tr) = _tied_inputs(seed)
    cfg = JRN.RetinaNetConfig(num_classes=NUM_CLASSES)
    port_cfg = RN.RetinaNetConfig(num_classes=NUM_CLASSES)
    if tfidf == "vector":
        vec = np.random.RandomState(9).uniform(0.5, 1.5, NUM_CLASSES).astype(np.float32)
        jax_tfidf, port_tfidf = jnp.asarray(vec), torch.from_numpy(vec)
    elif tfidf == "0-dim":
        jax_tfidf, port_tfidf = jnp.float32(0.9), torch.tensor(0.9)
    else:
        jax_tfidf = port_tfidf = tfidf
    ref = JRN.retinanet_postprocess(logits, reg, jnp.asarray(_anchors()), _level_sizes(),
                                    (IMG, IMG), cfg, tfidf_post=jax_tfidf, grids=_grids())
    out = RN.retinanet_postprocess(tl, tr, torch.from_numpy(_anchors()), _level_sizes(),
                                   (IMG, IMG), port_cfg, tfidf_post=port_tfidf)
    assert out[0].shape == (2, 300, 4)
    _assert_detections_equal(out, ref)
    assert out[3].any()
    # more than the 2000-candidate cap pass the threshold in each image
    assert int((tl.float() > -2.944).sum(dim=(1, 2)).min()) > 2000


def test_postprocess_stages_and_config():
    assert RN.RetinaNetConfig() == RN.RetinaNetConfig(
        **{f: getattr(JRN.RetinaNetConfig(), f) for f in RN.RetinaNetConfig.__dataclass_fields__})
    _, (tl, tr) = _tied_inputs(0)
    seen = []
    RN.retinanet_postprocess(tl, tr, torch.from_numpy(_anchors()), _level_sizes(), (IMG, IMG),
                             RN.RetinaNetConfig(num_classes=NUM_CLASSES), on_stage=seen.append)
    assert seen == ["select", "cap+decode", "NMS"]


def _jax_uint8_pipeline(model, v, u8):
    anchors = jnp.asarray(_anchors())
    cfg = JRN.RetinaNetConfig(num_classes=NUM_CLASSES)

    @jax.jit
    def infer(u8):
        cls, reg, level_sizes = model.apply(v, jax_preprocess(u8, jnp.float32), train=False)
        return JRN.retinanet_postprocess(cls, reg, anchors, tuple(level_sizes), (IMG, IMG),
                                         cfg, grids=_grids())

    return infer(jnp.asarray(u8))


def test_uint8_pipeline_matches_jax(tiny):
    model, v, port, _ = tiny
    u8 = np.random.RandomState(7).randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    ref = _jax_uint8_pipeline(model, v, u8)
    pipe = PL.build_retinanet_pipeline_uint8(num_classes=NUM_CLASSES, img_size=IMG,
                                             dtype=torch.float32, device="cpu", model=port)
    seen = []
    out = pipe(torch.from_numpy(u8), on_stage=seen.append)
    assert seen == ["normalize", "backbone+FPN", "head", "select", "cap+decode", "NMS"]
    # the two networks' f32 deltas differ by about 1e-6, so box corners
    # near 80 px differ by up to two f32 ulps (1.1e-5 seen): 1e-5 relative
    _assert_detections_equal(out, ref, rtol=1e-5)
    assert out[3].sum() > 0  # detections pass the 0.05 threshold


def test_pipeline_bf16_with_fused_backbone_runs_on_cpu(tiny):
    """bf16 on the CPU: "interpret" runs the fused plain version in 4 of
    the 4 stride-1 blocks; "auto" takes the unfused path on the CPU."""
    *_, port, _ = tiny
    u8 = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, IMG, IMG, 3))
                          .astype(np.uint8))
    outs = {}
    for mode in ("off", "auto", "interpret"):
        model = RN.RetinaNet(NUM_CLASSES, LAYERS, backbone_fused=mode)
        model.load_state_dict(port.state_dict())
        pipe = PL.build_retinanet_pipeline_uint8(num_classes=NUM_CLASSES, img_size=IMG,
                                                 device="cpu", model=model)
        outs[mode] = pipe(u8)
        assert pipe.model.dtype == torch.bfloat16 and model.dtype == torch.float32
        assert torch.isfinite(outs[mode][0]).all()
    assert all(torch.equal(a, b) for a, b in zip(outs["off"], outs["auto"]))


def test_init_and_defaults():
    model = RN.init_retinanet_(RN.RetinaNet(NUM_CLASSES, LAYERS), seed=3)
    np.testing.assert_allclose(model.head.cls_logits.bias.detach().numpy(), -np.log(99.0), rtol=1e-6)
    assert float(model.head.cls_conv0.weight.std()) == pytest.approx(0.01, rel=0.05)
    assert float(model.backbone.resnet.conv1.weight.std()) == pytest.approx(147 ** -0.5, rel=0.1)
    pipe = PL.build_retinanet_pipeline_uint8(num_classes=NUM_CLASSES, img_size=IMG,
                                             device="cpu", model=model)
    assert pipe.anchors.shape == (1746, 4) and pipe.cfg.detections_per_img == 300
    with pytest.raises(ValueError, match="images"):
        pipe(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))


def test_cuda_retinanet_pipeline_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.build_retinanet_pipeline_uint8()
