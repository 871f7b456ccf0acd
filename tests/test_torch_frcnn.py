"""The port's Faster R-CNN inference path (object_detectors_tpu_torch)
against the JAX FasterRCNN, module by module and whole, in float32 on the
CPU with the same weights moved by utils/weights.py."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.kernels.preprocess import preprocess_images as jax_preprocess
from object_detectors_tpu.models import anchors as jax_anchors
from object_detectors_tpu.models import faster_rcnn as JF
from object_detectors_tpu.models import fpn as JFPN
from object_detectors_tpu.models import roi_heads as JRH
from object_detectors_tpu.models import rpn as JRPN
from object_detectors_tpu.ops import boxes as jax_boxes
from object_detectors_tpu.ops import selection as jax_sel
from object_detectors_tpu_torch import pipeline as PL
from object_detectors_tpu_torch.models import anchors as A
from object_detectors_tpu_torch.models import faster_rcnn as F
from object_detectors_tpu_torch.models import fpn as FPN
from object_detectors_tpu_torch.models import roi_heads as RH
from object_detectors_tpu_torch.models import rpn as RPN
from object_detectors_tpu_torch.ops import boxes as B
from object_detectors_tpu_torch.ops import selection as SEL
from object_detectors_tpu_torch.utils.weights import flax_frcnn_to_torch
from test_two_stage import TINY_ROI, TINY_RPN

ROOT = Path(__file__).resolve().parent.parent
IMG = 96
NUM_CLASSES = 5
CLS_SCALE = 40.0  # spreads the class scores: some pass 0.05, some do not


def port_rpn_config(cfg) -> RPN.RPNConfig:
    return RPN.RPNConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(RPN.RPNConfig)})


def port_roi_config(cfg) -> RH.RoIHeadsConfig:
    return RH.RoIHeadsConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(RH.RoIHeadsConfig)})


def port_config(cfg) -> F.FasterRCNNConfig:
    return F.FasterRCNNConfig(num_classes=cfg.num_classes, rpn=port_rpn_config(cfg.rpn),
                              roi=port_roi_config(cfg.roi), resnet_layers=cfg.resnet_layers)


def randomized_frozen(frozen, seed):
    """Frozen batch norm statistics drawn at random: the init values
    (1, 0, 0, 1) would hide a swapped mapping."""
    rng = np.random.RandomState(seed)
    ranges = {"weight": (0.5, 1.5), "bias": (-0.2, 0.2), "running_mean": (-0.2, 0.2),
              "running_var": (0.5, 2.0)}
    return jax.tree_util.tree_map_with_path(
        lambda path, x: rng.uniform(*ranges[path[-1].key], x.shape).astype(np.float32),
        frozen)


def torch_frcnn(cfg, params, frozen) -> F.FasterRCNN:
    model = F.FasterRCNN(port_config(cfg))
    model.load_state_dict(flax_frcnn_to_torch(params, frozen))
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    """Tiny R(1,1,1,1)-FPN Faster R-CNN at 96 px: JAX model, numpy
    variables (random frozen statistics, class scores scaled) and the port
    model holding the same weights."""
    cfg = JF.FasterRCNNConfig(num_classes=NUM_CLASSES, rpn=TINY_RPN,
                              roi=dataclasses.replace(TINY_ROI, pooler_method="canvas"),
                              resnet_layers=(1, 1, 1, 1))
    model = JF.FasterRCNN(cfg, dtype=jnp.float32)
    v = model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["frozen"] = randomized_frozen(v["frozen"], 1)
    cls = v["params"]["box_predictor"]["cls_score"]
    cls["kernel"] = cls["kernel"] * CLS_SCALE
    x = np.random.RandomState(2).randn(2, IMG, IMG, 3).astype(np.float32)
    return cfg, model, v, torch_frcnn(cfg, v["params"], v["frozen"]), x


def nchw(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (a view)."""
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


# -- ops/boxes.py, ops/selection.py, models/anchors.py ----------------------

def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    boxes = (rng.rand(3, 50, 4) * 120 - 10).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + np.abs(boxes[..., 2:]) * 0.5
    codes = (rng.randn(3, 50, 4) * 2).astype(np.float32)
    codes[0, :5, 2:] = 9.0  # beyond the exp clip
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        out = B.decode_boxes(torch.from_numpy(codes), torch.from_numpy(boxes), weights)
        ref = jax_boxes.decode_boxes(jnp.asarray(codes), jnp.asarray(boxes), weights)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)
    clipped = B.clip_boxes_to_image(torch.from_numpy(boxes), (64, 96))
    np.testing.assert_array_equal(
        clipped.numpy(), np.asarray(jax_boxes.clip_boxes_to_image(jnp.asarray(boxes), (64, 96))))
    np.testing.assert_array_equal(
        B.small_box_mask(clipped, 3.0).numpy(),
        np.asarray(jax_boxes.small_box_mask(jnp.asarray(clipped.numpy()), 3.0)))
    assert B.BBOX_XFORM_CLIP == jax_boxes.BBOX_XFORM_CLIP


@pytest.mark.parametrize("n,k", [(5000, 1000), (700, 64), (300, 1000), (129, 128)])
def test_radix_topk_is_the_jax_set(n, k):
    rng = np.random.RandomState(n)
    scores = rng.randint(0, 40, (3, n)).astype(np.float32) / 7  # many ties
    scores[0, ::5] = -np.inf
    scores[1, ::7] = np.nan
    scores[2, :20] = -0.0
    scores[2, 20:40] = 0.0
    out_v, out_i = SEL.radix_topk(torch.from_numpy(scores), k)
    for row in range(3):
        ref_v, ref_i = jax_sel.radix_topk(jnp.asarray(scores[row]), k)
        assert sorted(out_i[row].tolist()) == sorted(np.asarray(ref_i).tolist())
        np.testing.assert_array_equal(np.sort(out_v[row].numpy()), np.sort(np.asarray(ref_v)))


def test_radix_topk_multi_matches_jax():
    rng = np.random.RandomState(4)
    rows = [rng.randn(n).astype(np.float32) for n in (1728, 432, 108, 12)]
    ks = (64, 64, 64, 12)
    out = SEL.radix_topk_multi([torch.from_numpy(r) for r in rows], ks)
    ref = jax_sel.radix_topk_multi(tuple(jnp.asarray(r) for r in rows), ks)
    for (ov, oi), (rv, ri) in zip(out, ref):
        assert sorted(oi.tolist()) == sorted(np.asarray(ri).tolist())


@pytest.mark.parametrize("src,dst", [((38, 38), (75, 75)), ((13, 19), (25, 38)),
                                     ((3, 3), (5, 5)), ((4, 6), (8, 12))])
def test_upsample_nearest_to_is_the_jax_resize(src, dst):
    """Bitwise, at factors that are not integers (JAX's ``jax.image.resize``
    fallback) and at an integer one (its broadcast)."""
    x = np.random.RandomState(sum(src)).randn(2, *src, 3).astype(np.float32)
    ref = np.asarray(JFPN._upsample_nearest_to(jnp.asarray(x), dst))
    out = FPN.upsample_nearest_to(nchw(x), dst).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out, ref)


def test_anchors_match_jax():
    grids = [(24, 24), (12, 12), (6, 6), (3, 3), (2, 2)]
    sizes, ratios = A.rpn_anchor_config()
    assert (sizes, ratios) == jax_anchors.rpn_anchor_config()
    np.testing.assert_array_equal(A.grid_anchors((IMG, IMG), grids, sizes, ratios),
                                  jax_anchors.grid_anchors((IMG, IMG), grids, sizes, ratios))
    np.testing.assert_array_equal(A.cell_anchors((32, 64), (0.5, 1.0, 2.0)),
                                  jax_anchors.cell_anchors((32, 64), (0.5, 1.0, 2.0)))


# -- weights and modules ------------------------------------------------------

def test_converter_fills_every_tensor_of_the_model(tiny):
    cfg, _, v, _, _ = tiny
    state = flax_frcnn_to_torch(v["params"], v["frozen"])
    model = F.FasterRCNN(port_config(cfg))
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert state[name].shape == t.shape, name


def _jax_features(model, v, x):
    return model.apply(v, jnp.asarray(x), method=lambda m, x: m.backbone(x, False))


def test_backbone_features_match_jax(tiny):
    _, model, v, port, x = tiny
    ref = _jax_features(model, v, x)
    with torch.no_grad():
        out = port.backbone(nchw(x).contiguous(memory_format=torch.channels_last))
    assert len(out) == len(ref) == 5
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.permute(0, 2, 3, 1).shape == r.shape
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), r, rtol=1e-4, atol=1e-5)


def test_rpn_head_matches_jax(tiny):
    _, model, v, port, x = tiny
    feats = [np.asarray(f) for f in _jax_features(model, v, x)]
    obj_r, reg_r, sizes_r = model.apply(
        v, [jnp.asarray(f) for f in feats], method=lambda m, f: m.rpn_head(f))
    with torch.no_grad():
        obj, reg, sizes = port.rpn_head([nchw(f) for f in feats])
    assert sizes == sizes_r
    np.testing.assert_allclose(obj.numpy(), np.asarray(obj_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(reg.numpy(), np.asarray(reg_r), rtol=1e-4, atol=1e-5)


def _sorted_proposals(boxes, scores, valid):
    rows = np.concatenate([scores[valid][:, None], boxes[valid]], 1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_proposals_matches_jax(seed):
    rng = np.random.RandomState(seed)
    level_sizes = (24 * 24 * 3, 12 * 12 * 3, 6 * 6 * 3, 3 * 3 * 3, 2 * 2 * 3)
    total = sum(level_sizes)
    xy = rng.rand(2, total, 2).astype(np.float32) * 110 - 10
    props = np.concatenate([xy, xy + rng.rand(2, total, 2).astype(np.float32) * 40], -1)
    props[:, :30, 2:] = props[:, :30, :2] + 1e-4  # dropped as small
    obj = rng.randn(2, total).astype(np.float32)
    ref = [np.asarray(a) for a in JRPN.filter_proposals(
        jnp.asarray(props), jnp.asarray(obj), level_sizes, (IMG, IMG), TINY_RPN)]
    out = [t.numpy() for t in RPN.filter_proposals(
        torch.from_numpy(props), torch.from_numpy(obj), level_sizes, (IMG, IMG),
        port_rpn_config(TINY_RPN))]
    assert out[0].shape == ref[0].shape
    for b in range(2):
        np.testing.assert_array_equal(out[2][b].sum(), ref[2][b].sum())
        o = _sorted_proposals(out[0][b], out[1][b], out[2][b])
        r = _sorted_proposals(ref[0][b], ref[1][b], ref[2][b])
        np.testing.assert_array_equal(o[:, 1:], r[:, 1:])
        np.testing.assert_allclose(o[:, 0], r[:, 0], rtol=0, atol=1e-5)
    assert 0 < out[2].sum() < out[2].size + 1


def _postprocess_inputs(seed, p=16, c=NUM_CLASSES):
    rng = np.random.RandomState(seed)
    centers = rng.rand(2, 3, 2) * 70 + 10
    cxy = centers[:, rng.randint(0, 3, p)] + rng.randn(2, p, 2) * 3
    props = np.concatenate([cxy - 12, cxy + 12], -1).astype(np.float32)
    logits = (rng.randn(2, p, c) * 3).astype(np.float32)
    reg = (rng.randn(2, p, c * 4) * 0.1).astype(np.float32)
    valid = rng.rand(2, p) > 0.2
    return logits, reg, props, valid


def _scores(logits, scale, loss_type):
    """The postprocess's class scores, as JAX computes them per loss type."""
    scaled = torch.from_numpy(logits) * torch.as_tensor(scale)
    if loss_type == "ce":
        return torch.softmax(scaled, -1)
    if loss_type.startswith("gombit"):
        return RH._gombit_prob(scaled)
    return torch.sigmoid(scaled)


# the ce cases keep their ids; each other loss type gets one case
@pytest.mark.parametrize("seed,tfidf,loss_type", [
    pytest.param(0, None, "ce", id="0-None"), pytest.param(1, None, "ce", id="1-None"),
    pytest.param(2, "vector", "ce", id="2-vector"), (3, None, "bce"), (4, "vector", "focal_loss"),
    (5, None, "gombit"), (6, "vector", "gombit_fl")])
def test_postprocess_detections_matches_jax(seed, tfidf, loss_type):
    logits, reg, props, valid = _postprocess_inputs(seed)
    roi = dataclasses.replace(TINY_ROI, detections_per_img=40, loss_type=loss_type)
    scale = 1.0
    if tfidf == "vector":
        scale = np.random.RandomState(9).uniform(0.5, 2.0, NUM_CLASSES).astype(np.float32)
    ref = [np.asarray(a) for a in JRH.postprocess_detections(
        jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(props), jnp.asarray(valid),
        (IMG, IMG), roi, tfidf_post=jnp.asarray(scale))]
    out = [t.numpy() for t in RH.postprocess_detections(
        torch.from_numpy(logits), torch.from_numpy(reg), torch.from_numpy(props),
        torch.from_numpy(valid), (IMG, IMG), port_roi_config(roi),
        tfidf_post=torch.as_tensor(scale))]
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-4, atol=1e-6)
    # candidates above 0.05 exist, and NMS removed some of them
    scores = _scores(logits, scale, loss_type)[..., 1:]
    passing = int(((scores > roi.score_thresh) & torch.from_numpy(valid)[..., None]).sum())
    assert 0 < out[3].sum() < passing


def test_postprocess_rejects_an_unknown_loss_type():
    logits, reg, props, valid = _postprocess_inputs(0)
    with pytest.raises(ValueError, match="unknown loss_type"):
        RH.postprocess_detections(torch.from_numpy(logits), torch.from_numpy(reg),
                                  torch.from_numpy(props), torch.from_numpy(valid),
                                  (IMG, IMG), RH.RoIHeadsConfig(loss_type="softmax"))


# -- the whole model and the pipeline -----------------------------------------

def _assert_detections_equal(out, ref):
    out = [t.numpy() for t in out]
    ref = [np.asarray(r) for r in ref]
    np.testing.assert_array_equal(out[3], ref[3])  # valid
    np.testing.assert_array_equal(out[2], ref[2])  # labels
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-4, atol=1e-4)


def test_frcnn_eval_matches_jax(tiny):
    cfg, model, v, port, x = tiny
    ref = model.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out[0].shape == (2, TINY_ROI.detections_per_img, 4)
    _assert_detections_equal(out, ref)
    assert out[3].sum() > 0  # detections pass the 0.05 threshold

    def kept(nms_thresh):  # without the detection cap, with and without NMS
        roi = dataclasses.replace(port.cfg.roi, detections_per_img=1000, nms_thresh=nms_thresh)
        m = F.FasterRCNN(dataclasses.replace(port.cfg, roi=roi)).eval()
        m.load_state_dict(port.state_dict())
        with torch.no_grad():
            return int(m(torch.from_numpy(x))[3].sum())

    assert kept(0.5) < kept(1.0)  # NMS dropped some


def test_frcnn_eval_at_80px_matches_jax(tiny):
    """At 80 px C5 is 3 x 3, so the FPN's top-down pathway upsamples P5 to
    P4 by 5/3, where JAX falls back to ``jax.image.resize``."""
    cfg, model, v, port, _ = tiny
    x = np.random.RandomState(12).randn(2, 80, 80, 3).astype(np.float32)
    ref = model.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    _assert_detections_equal(out, ref)
    assert out[3].sum() > 0


def test_frcnn_eval_tfidf_vector_matches_jax(tiny):
    """``tfidf`` reaches the postprocess as ``tfidf_post``, as in JAX."""
    cfg, model, v, port, x = tiny
    vec = np.random.RandomState(11).uniform(0.3, 3.0, NUM_CLASSES).astype(np.float32)
    ref = model.apply(v, jnp.asarray(x), train=False, tfidf=jnp.asarray(vec))
    with torch.no_grad():
        out = port(torch.from_numpy(x), tfidf=torch.from_numpy(vec))
        plain = port(torch.from_numpy(x))
    _assert_detections_equal(out, ref)
    assert out[3].sum() > 0
    assert not all(torch.equal(a, b) for a, b in zip(out, plain))  # the vector mattered


def test_frcnn_stages_are_reported_in_order(tiny):
    *_, port, x = tiny
    seen = []
    with torch.no_grad():
        port(torch.from_numpy(x[:1]), on_stage=seen.append)
    assert seen == ["backbone+FPN", "RPN head", "proposal filter", "pooler", "box head",
                    "postprocess"]


def test_frcnn_training_is_not_ported(tiny):
    """Training without targets is refused; with them it returns the four
    losses (held against JAX in test_torch_frcnn_train.py)."""
    *_, port, x = tiny
    with pytest.raises(ValueError):
        port(torch.from_numpy(x), train=True)
    gt = torch.tensor([[[4.0, 4.0, 40.0, 44.0]]] * 2)
    losses = port.train()(torch.from_numpy(x), gt, torch.ones(2, 1, dtype=torch.long),
                          torch.ones(2, 1, dtype=torch.bool), train=True,
                          generator=torch.Generator().manual_seed(0))
    port.eval()
    assert sorted(losses) == ["loss_box_reg", "loss_classifier", "loss_objectness",
                              "loss_rpn_box_reg"]
    assert all(torch.isfinite(v) for v in losses.values())


def test_uint8_pipeline_matches_jax(tiny):
    _, model, v, port, _ = tiny
    u8 = np.random.RandomState(3).randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    ref = model.apply(v, jax_preprocess(jnp.asarray(u8), jnp.float32), train=False)
    pipe = PL.build_frcnn_pipeline_uint8(num_classes=NUM_CLASSES, img_size=IMG,
                                         dtype=torch.float32, device="cpu", model=port)
    assert pipe.model is not port
    _assert_detections_equal(pipe(torch.from_numpy(u8)), ref)
    with pytest.raises(ValueError, match="images"):
        pipe(torch.from_numpy(u8[:, :64]))


def test_frcnn_pipeline_defaults():
    pipe = PL.build_frcnn_pipeline_uint8(device="cpu")
    cfg = pipe.model.cfg
    assert (pipe.img_size, pipe.dtype, pipe.model.dtype) == (640, torch.bfloat16, torch.bfloat16)
    assert cfg.num_classes == 91 and cfg.resnet_layers == (3, 4, 6, 3)
    assert (cfg.rpn.pre_nms_top_n_test, cfg.rpn.post_nms_top_n_test, cfg.rpn.nms_thresh) == (
        1000, 1000, 0.7)
    assert (cfg.roi.score_thresh, cfg.roi.nms_thresh, cfg.roi.detections_per_img,
            cfg.roi.pre_nms_candidates, cfg.roi.pool_size) == (0.05, 0.5, 100, 1000, (7, 7))
    assert port_config(JF.FasterRCNNConfig()) == F.FasterRCNNConfig()
    assert pipe.model.box_predictor.cls_score.out_features == 91


def test_frcnn_pipeline_bf16_runs_on_cpu(tiny):
    *_, port, _ = tiny
    pipe = PL.build_frcnn_pipeline_uint8(num_classes=NUM_CLASSES, img_size=64, device="cpu",
                                         model=port)
    u8 = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3)).astype(np.uint8))
    boxes, scores, labels, valid = pipe(u8)
    assert boxes.dtype == torch.float32 and labels.dtype == torch.int32
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
    assert port.dtype == torch.float32  # the caller's model is left as it was


def test_cuda_frcnn_pipeline_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.build_frcnn_pipeline_uint8()


def test_trained_synthetic_frcnn_matches_jax():
    """R50-FPN trained on the synthetic family (5 classes, 96 px): the
    port's detections equal JAX's on a rendered image of that family."""
    from flax import serialization

    from object_detectors_tpu.data import synthetic as SYN

    cfg = JF.FasterRCNNConfig(num_classes=NUM_CLASSES)
    model = JF.FasterRCNN(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                               train=False))
    # the frozen statistics of the artifact are the init values
    frozen = jax.tree_util.tree_map_with_path(
        lambda path, s: (np.ones if path[-1].key in ("weight", "running_var")
                         else np.zeros)(s.shape, np.float32), shapes["frozen"])
    art = ROOT / "artifacts" / "synthetic_frcnn.msgpack"
    params = serialization.msgpack_restore(art.read_bytes())["params"]

    gt, loader = SYN.renderable_dataset(np.random.RandomState(5), num_images=2, img_size=IMG,
                                        num_classes=NUM_CLASSES - 1)
    u8 = np.stack([loader(info) for info in gt["images"]]).astype(np.uint8)
    ref = jax.jit(lambda v, x: model.apply(v, jax_preprocess(x, jnp.float32), train=False))(
        {"params": params, "frozen": frozen}, jnp.asarray(u8))
    pipe = PL.build_frcnn_pipeline_uint8(num_classes=NUM_CLASSES, img_size=IMG,
                                         dtype=torch.float32, device="cpu",
                                         model=torch_frcnn(cfg, params, frozen))
    out = pipe(torch.from_numpy(u8))
    _assert_detections_equal(out, ref)
    assert out[3].sum() > 0  # the trained detector fires on its own family
