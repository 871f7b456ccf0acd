"""The port's losses (object_detectors_tpu_torch/ops/losses.py), box
geometry (ops/boxes.py: converters, box_iou at all four iou_types,
encode_boxes) and minibatch idf (data/idf.py) against the JAX functions, in
float32 on the CPU with the same numpy-seeded inputs. Tolerance: rtol 1e-5,
atol 1e-6 (the same formulas in the same order; transcendental functions
differ by an ulp between the libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.data import idf as jax_idf
from object_detectors_tpu.ops import boxes as JB
from object_detectors_tpu.ops import losses as JL
from object_detectors_tpu_torch.data import idf as I
from object_detectors_tpu_torch.ops import boxes as B
from object_detectors_tpu_torch.ops import losses as L

RTOL, ATOL = 1e-5, 1e-6


def close(out, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def inputs(seed=0, shape=(6, 7)):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape) * 4).astype(np.float32)
    labels = (rng.rand(*shape) < 0.3).astype(np.float32)
    return logits, labels


REDUCED = {
    "focal_loss": {"gamma": 1.5, "alpha": 0.25},
    "sigmoid_focal_loss": {"alpha": 0.25, "gamma": 2.0},
    "sigmoid_focal_loss_no_alpha": {"alpha": -1.0},
    "quality_focal_loss": {"gamma": 1.5},
}


@pytest.mark.parametrize("name", sorted(REDUCED))
@pytest.mark.parametrize("reduction", ["none", "mean", "sum"])
def test_focal_family_matches_jax(name, reduction):
    logits, labels = inputs(1)
    fn = name.replace("_no_alpha", "")
    out = getattr(L, fn)(torch.from_numpy(logits), torch.from_numpy(labels),
                         reduction=reduction, **REDUCED[name])
    ref = getattr(JL, fn)(jnp.asarray(logits), jnp.asarray(labels), reduction=reduction,
                          **REDUCED[name])
    close(out, ref)


@pytest.mark.parametrize("name,kwargs", [("sigmoid_binary_cross_entropy", {}),
                                         ("bce_blur_with_logits", {"alpha": 0.05}),
                                         ("focal_modulation", {"gamma": 2.0, "alpha": 0.3})])
def test_elementwise_losses_match_jax(name, kwargs):
    logits, labels = inputs(1)
    close(getattr(L, name)(torch.from_numpy(logits), torch.from_numpy(labels), **kwargs),
          getattr(JL, name)(jnp.asarray(logits), jnp.asarray(labels), **kwargs))


def test_pos_weight_bce_and_focal_match_jax():
    logits, labels = inputs(2)
    pw = np.random.RandomState(3).rand(7).astype(np.float32) * 3
    close(L.sigmoid_binary_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                         torch.from_numpy(pw)),
          JL.sigmoid_binary_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                          jnp.asarray(pw)))
    close(L.focal_loss(torch.from_numpy(logits), torch.from_numpy(labels), 1.0, 0.5,
                       torch.from_numpy(pw), "sum"),
          JL.focal_loss(jnp.asarray(logits), jnp.asarray(labels), 1.0, 0.5, jnp.asarray(pw),
                        "sum"))


@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_ce_and_weighted_mean_match_jax(weighted):
    rng = np.random.RandomState(4)
    logits = (rng.randn(20, 9) * 3).astype(np.float32)
    labels = rng.randint(0, 9, 20)
    w = (rng.rand(9) + 0.2).astype(np.float32) if weighted else None
    mask = (rng.rand(20) < 0.6).astype(np.float32)
    tw = None if w is None else torch.from_numpy(w)
    jw = None if w is None else jnp.asarray(w)
    close(L.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), tw),
          JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jw))
    close(L.weighted_ce_mean(torch.from_numpy(logits), torch.from_numpy(labels), tw,
                             torch.from_numpy(mask)),
          JL.weighted_ce_mean(jnp.asarray(logits), jnp.asarray(labels), jw, jnp.asarray(mask)))


def test_eq_loss_matches_jax():
    logits, labels = inputs(5, (8, 6))
    rare = np.array([1, 0, 0, 1, 0, 1], np.float32)
    pw = np.linspace(0.5, 2, 6).astype(np.float32)
    for reduction in ("none", "sum"):
        close(L.eq_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(rare), 1.5, 0.25, torch.from_numpy(pw), reduction),
              JL.eq_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(rare), 1.5,
                         0.25, jnp.asarray(pw), reduction))


@pytest.mark.parametrize("beta", [1.0, 1.0 / 9])
def test_regression_losses_match_jax(beta):
    rng = np.random.RandomState(6)
    pred = rng.randn(30, 4).astype(np.float32)
    tgt = rng.randn(30, 4).astype(np.float32)
    for reduction in ("none", "mean", "sum"):
        close(L.smooth_l1_loss(torch.from_numpy(pred), torch.from_numpy(tgt), beta, reduction),
              JL.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(tgt), beta, reduction))
        close(L.l1_loss(torch.from_numpy(pred), torch.from_numpy(tgt), reduction),
              JL.l1_loss(jnp.asarray(pred), jnp.asarray(tgt), reduction))
        close(L.mse_loss(torch.from_numpy(pred), torch.from_numpy(tgt), reduction),
              JL.mse_loss(jnp.asarray(pred), jnp.asarray(tgt), reduction))


def test_smooth_targets_and_effective_number_weights_match_jax():
    assert L.smooth_bce_targets(0.2) == JL.smooth_bce_targets(0.2)
    counts = np.array([1, 10, 100, 5000, 3], np.float32)
    close(L.effective_number_weights(counts), JL.effective_number_weights(counts))


def test_one_hot_is_jax_one_hot():
    labels = np.array([[0, 3, 5, -1], [2, 2, 9, 4]])
    np.testing.assert_array_equal(L.one_hot(torch.from_numpy(labels), 5).numpy(),
                                  np.asarray(jax.nn.one_hot(jnp.asarray(labels), 5)))


def boxes(seed, n, fmt):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2).astype(np.float32) * 50
    wh = rng.rand(n, 2).astype(np.float32) * 40 + 0.5
    if fmt == "cxcywh":
        return np.concatenate([xy, wh], 1)
    return np.concatenate([xy, xy + wh], 1)


@pytest.mark.parametrize("iou_type", [B.IOU, B.GIOU, B.DIOU, B.CIOU])
@pytest.mark.parametrize("fmt", ["cxcywh", "xyxy"])
def test_box_iou_matches_jax(iou_type, fmt):
    b1 = boxes(7, 12, fmt)
    b2 = boxes(8, 9, fmt)
    b1[:2] = b2[:2]  # identical pairs
    b1[2, 2:] = b1[2, :2] if fmt == "xyxy" else 0.0  # a box of zero area
    a = torch.from_numpy(b1)[:, None]
    b = torch.from_numpy(b2)[None]
    out = B.box_iou(a, b, iou_type, fmt)
    ref = JB.box_iou(jnp.asarray(b1)[:, None], jnp.asarray(b2)[None], iou_type=iou_type,
                     fmt=fmt)
    assert out.shape == (12, 9)
    close(out, ref, atol=1e-5)


@pytest.mark.parametrize("iou_type", [B.GIOU, B.CIOU])
def test_box_iou_gradient_matches_jax(iou_type):
    """CIoU's alpha carries no gradient on either side."""
    b1 = boxes(9, 10, "cxcywh")
    b2 = boxes(10, 10, "cxcywh")
    t = torch.from_numpy(b1).requires_grad_()
    B.box_iou(t, torch.from_numpy(b2), iou_type).sum().backward()
    ref = jax.grad(lambda x: JB.box_iou(x, jnp.asarray(b2), iou_type=iou_type).sum())(
        jnp.asarray(b1))
    close(t.grad, ref, rtol=1e-4, atol=1e-6)


def test_converters_and_encode_match_jax():
    b = boxes(11, 20, "xyxy")
    for name in ("cxcywh_to_xyxy", "xyxy_to_cxcywh", "xywh_to_xyxy", "xyxy_to_xywh"):
        close(getattr(B, name)(torch.from_numpy(b)), getattr(JB, name)(jnp.asarray(b)))
    p = boxes(12, 20, "xyxy")
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        close(B.encode_boxes(torch.from_numpy(b), torch.from_numpy(p), w),
              JB.encode_boxes(jnp.asarray(b), jnp.asarray(p), w), atol=1e-5)


def test_minibatch_idf_and_eq_rare_mask_match_jax():
    rng = np.random.RandomState(13)
    labels = rng.randint(0, 7, (5, 6))
    labels[0, 0] = 9  # out of range, as jax.nn.one_hot drops it
    valid = rng.rand(5, 6) < 0.6
    close(I.minibatch_idf(torch.from_numpy(labels), torch.from_numpy(valid), 8),
          jax_idf.minibatch_idf(jnp.asarray(labels), jnp.asarray(valid), 8))
    freq = rng.randint(0, 1000, 30).astype(np.float64)
    freq[:3] = 1
    np.testing.assert_array_equal(I.eq_rare_mask(freq), jax_idf.eq_rare_mask(freq))
