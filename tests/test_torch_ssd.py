"""The port's SSD300 (object_detectors_tpu_torch: models/anchors.py
ssd_default_boxes, ops/matcher.py ssd_match, models/ssd.py) against the JAX
functions in float32 on the CPU, on the same numpy-seeded inputs and, for
the network, the same weights moved by utils/weights.py.

The default boxes are host numpy and must be bitwise equal; matches, the
hard-negative sets, labels, kept sets and valid flags exact; losses and
their gradients within rtol 1e-4; scores within 1e-5 and boxes within 1e-4
(a few f32 ulps at 300 px)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.models import anchors as JA
from object_detectors_tpu.models import ssd as JS
from object_detectors_tpu.ops import matcher as JM
from object_detectors_tpu_torch.models import anchors as A
from object_detectors_tpu_torch.models import ssd as S
from object_detectors_tpu_torch.ops import matcher as M
from object_detectors_tpu_torch.utils.weights import flax_ssd_to_torch
from test_torch_mask_rcnn import seeded_params

SSD_LEVELS = ((38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1))


def port_ssd_config(cfg) -> S.SSDConfig:
    return S.SSDConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(S.SSDConfig)})


@pytest.mark.parametrize("kw", [
    dict(image_size=(300, 300), grid_sizes=SSD_LEVELS),
    dict(image_size=(512, 384), grid_sizes=((64, 48), (32, 24), (16, 12), (8, 6), (4, 3),
                                            (2, 1))),
    dict(image_size=(512, 512), grid_sizes=((64, 64), (32, 32), (16, 16), (8, 8), (6, 6),
                                            (4, 4))),
    dict(image_size=(96, 96), grid_sizes=((12, 12), (6, 6), (3, 3))),
])
def test_ssd_default_boxes_are_jax_s_bitwise(kw):
    out = A.ssd_default_boxes(**kw)
    ref = JA.ssd_default_boxes(**kw)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_ssd_match_is_jax_s_with_colliding_gts():
    rng = np.random.RandomState(0)
    q = (rng.randint(0, 12, (3, 6, 50)) / 12).astype(np.float32)  # many ties
    q[0, 1, 7] = q[0, 4, 7] = 0.99  # two GTs best at the same prediction: 4 wins
    q[0, 2, :] = 0.3                 # a GT tied everywhere claims the first
    q[1, 0, 9] = q[1, 5, 9] = 0.97
    valid = rng.rand(3, 6) < 0.8
    valid[0, [1, 2, 4]] = True
    valid[1, [0]] = True
    valid[1, 5] = False              # an invalid GT claims nothing
    valid[2] = False                 # no valid GT at all
    for i in range(3):
        ref = JM.ssd_match(jnp.asarray(q[i]), jnp.asarray(valid[i]), 0.5)
        out = M.ssd_match(torch.from_numpy(q[i]), torch.from_numpy(valid[i]), 0.5)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    batched = M.ssd_match(torch.from_numpy(q), torch.from_numpy(valid), 0.5)
    ref = jax.vmap(lambda a, b: JM.ssd_match(a, b, 0.5))(jnp.asarray(q), jnp.asarray(valid))
    np.testing.assert_array_equal(batched.numpy(), np.asarray(ref))
    assert batched[0, 7] == 4 and batched[1, 9] == 0 and batched[0, 0] == 2
    assert (batched[2] == -1).all()


def loss_inputs(seed, b=2, m=4, levels=((12, 12), (6, 6), (3, 3)), size=96):
    rng = np.random.RandomState(seed)
    anchors = A.ssd_default_boxes((size, size), levels)
    a = anchors.shape[0]
    xy = rng.rand(b, m, 2) * (size - 40)
    gt = np.concatenate([xy, xy + 12 + rng.rand(b, m, 2) * 28], -1).astype(np.float32)
    labels = rng.randint(1, 5, (b, m))
    valid = rng.rand(b, m) < 0.8
    valid[:, 0] = True
    cls = (rng.randn(b, a, 5) * 2).astype(np.float32)
    # ties in the hard-negative rank: rows of equal logits give equal CE
    cls[:, 10:40] = cls[:, 10:11]
    cls[:, 60:90] = cls[:, 9:10]
    reg = (rng.randn(b, a, 4) * 0.5).astype(np.float32)
    return anchors, gt, labels, valid, cls, reg


@pytest.mark.parametrize("mini_batch, norm", [(False, 0), (True, 0), (True, 2)])
def test_ssd_loss_and_gradients_match_jax(mini_batch, norm):
    anchors, gt, labels, valid, cls, reg = loss_inputs(1)
    cfg = JS.SSDConfig(num_classes=5, tfidf_mini_batch=mini_batch, tfidf_norm=norm)
    args = (jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid))

    def jax_total(c, r):
        out = JS.ssd_loss(c, r, *args, cfg)
        return out["bbox_regression"] + out["classification"], out

    (_, ref), grads = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    t_cls = torch.from_numpy(cls).requires_grad_()
    t_reg = torch.from_numpy(reg).requires_grad_()
    out = S.ssd_loss(t_cls, t_reg, *[torch.from_numpy(x) for x in (anchors, gt, labels, valid)],
                     port_ssd_config(cfg))
    assert list(out) == list(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    sum(out.values()).backward()
    for t, g in zip((t_cls, t_reg), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7)
        # the same anchors mined as hard negatives: the same nonzero gradients
        np.testing.assert_array_equal(t.grad.numpy() != 0, np.asarray(g) != 0)


def test_ssd_loss_background_image_matches_jax():
    anchors, _, _, _, cls, reg = loss_inputs(2, b=1)
    cfg = JS.SSDConfig(num_classes=5)
    z = (np.zeros((1, 1, 4), np.float32), np.zeros((1, 1), np.int64), np.zeros((1, 1), bool))
    ref = JS.ssd_loss(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(anchors),
                      *[jnp.asarray(x) for x in z], cfg)
    out = S.ssd_loss(torch.from_numpy(cls), torch.from_numpy(reg), torch.from_numpy(anchors),
                     *[torch.from_numpy(x) for x in z], port_ssd_config(cfg))
    for k in ref:
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    assert out["bbox_regression"].item() == 0.0


@pytest.mark.parametrize("tfidf", [1.0, "vector"])
def test_ssd_postprocess_matches_jax(tfidf):
    rng = np.random.RandomState(3)
    anchors = A.ssd_default_boxes((300, 300), SSD_LEVELS)
    a = anchors.shape[0]
    cfg = JS.SSDConfig(num_classes=6, detections_per_img=50, topk_candidates=60)
    logits = rng.randn(2, a, 6).astype(np.float32)
    logits[..., 0] += 3.0
    logits[0, 100:140, 2] = 9.0       # a cluster of one class, all tied
    logits[1, 500:520, 4] = 7.0
    reg = (rng.randn(2, a, 4) * 0.3).astype(np.float32)
    t = (np.linspace(0.5, 2.0, 6).astype(np.float32) if tfidf == "vector" else tfidf)
    ref = JS.ssd_postprocess(jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(anchors),
                             (300, 300), cfg, tfidf_post=jnp.asarray(t))
    out = S.ssd_postprocess(torch.from_numpy(logits), torch.from_numpy(reg),
                            torch.from_numpy(anchors), (300, 300), port_ssd_config(cfg),
                            tfidf_post=torch.as_tensor(t))
    ref = [np.asarray(x) for x in ref]
    np.testing.assert_array_equal(out[3].numpy(), ref[3])
    np.testing.assert_array_equal(out[2].numpy(), ref[2])
    np.testing.assert_allclose(out[1].numpy(), ref[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[0].numpy(), ref[0], rtol=0, atol=1e-4)
    assert ref[3].sum(1).min() > 0


@pytest.fixture(scope="module")
def ssd300():
    """The full-width JAX SSD300 (6 classes) at 300², its variables, and
    the port model holding the same weights."""
    cfg = JS.SSDConfig(num_classes=6)
    model = JS.SSD300(cfg)
    x = np.random.RandomState(4).randn(1, 300, 300, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.asarray(x),
                                               train=False))
    params = seeded_params(dict(shapes["params"]), 0, bias_std=0.01)
    # a scale_weight away from its init, so that a dropped leaf shows
    params["backbone"]["scale_weight"] = np.linspace(5, 30, 512).astype(np.float32)
    # the head's outputs and the six level maps in one compile
    out, feats = jax.jit(lambda p, im: (model.apply({"params": p}, im),
                                        JS.VGGFeatureExtractor().apply(
                                            {"params": p["backbone"]}, im)))(
        params, jnp.asarray(x))
    port = S.SSD300(port_ssd_config(cfg))
    port.load_state_dict(flax_ssd_to_torch(params))
    return dict(port=port.eval(), x=x, out=out, feats=feats)


def test_vgg_ssd300_forward_matches_jax(ssd300):
    t = ssd300
    cls_j, reg_j, sizes_j = t["out"]
    with torch.no_grad():
        cls, reg, sizes = t["port"](torch.from_numpy(t["x"]))
    assert sizes == tuple(sizes_j) == tuple(h * w * a for (h, w), a in
                                            zip(SSD_LEVELS, S.ANCHORS_PER_LOCATION))
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(reg.numpy(), np.asarray(reg_j), rtol=1e-4, atol=1e-4)


def test_vgg_level_maps_match_jax(ssd300):
    """Each of the six maps (the L2 norm, the ceil pool's edge pad, conv6's
    dilation, the SAME padding at stride 2, the VALID convs)."""
    t = ssd300
    feats_j = t["feats"]
    with torch.no_grad():
        feats = t["port"].backbone(torch.from_numpy(t["x"]).permute(0, 3, 1, 2))
    for i, (f, r) in enumerate(zip(feats, feats_j)):
        r = np.asarray(r).transpose(0, 3, 1, 2)
        assert f.shape == r.shape, i
        np.testing.assert_allclose(f.numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"level {i}")


def test_same_padding_is_flax_s():
    """Flax "SAME" at stride 2 on an even size pads one pixel at the end."""
    rng = np.random.RandomState(5)
    for size, stride, dil in ((10, 2, 1), (9, 2, 1), (7, 1, 6), (5, 1, 1)):
        x = rng.randn(1, size, size, 3).astype(np.float32)
        k = rng.randn(3, 3, 3, 4).astype(np.float32)
        ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (stride, stride),
                                           "SAME", rhs_dilation=(dil, dil),
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"))
        conv = S.SameConv(3, 4, 3, stride=stride, dilation=dil)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
            conv.bias.zero_()
            out = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
