"""The port's Faster R-CNN training (object_detectors_tpu_torch: ops/matcher.py,
ops/sampler.py, models/rpn.py rpn_loss and the training filter,
models/roi_heads.py select_training_samples / fastrcnn_loss,
models/faster_rcnn.py train=True, train/trainer.py frcnn_train_step)
against the JAX functions in float32 on the CPU, with the same inputs and
the JAX sampler's own uniforms, replayed from the same keys.

Discrete results (matches with their -1 / -2 codes, sampled sets, the
slots' order, NMS kept sets) must be identical; losses agree within rtol
1e-4 and gradients within GRAD_RTOL / GRAD_ATOL."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.models import faster_rcnn as JF
from object_detectors_tpu.models import roi_heads as JRH
from object_detectors_tpu.models import rpn as JRPN
from object_detectors_tpu.ops import matcher as JM
from object_detectors_tpu.ops import sampler as JS
from object_detectors_tpu_torch.kernels.fused_block import fold_bn
from object_detectors_tpu_torch.models import faster_rcnn as F
from object_detectors_tpu_torch.models import roi_heads as RH
from object_detectors_tpu_torch.models import rpn as RPN
from object_detectors_tpu_torch.ops import matcher as M
from object_detectors_tpu_torch.ops import sampler as S
from object_detectors_tpu_torch.train import optim as O
from object_detectors_tpu_torch.train import trainer as T
from object_detectors_tpu_torch.utils.weights import flax_frcnn_to_torch
from test_torch_frcnn import port_config, port_roi_config, port_rpn_config, randomized_frozen

IMG = 64
# __graft_entry__._dryrun_frcnn's configuration
TINY_RPN = JRPN.RPNConfig(pre_nms_top_n_train=32, pre_nms_top_n_test=32,
                          post_nms_top_n_train=16, post_nms_top_n_test=8,
                          batch_size_per_image=16)
TINY_ROI = JRH.RoIHeadsConfig(num_classes=5, batch_size_per_image=8, detections_per_img=4)
# gradients of the whole model: float32 sums in other orders through
# ResNet-FPN, RoIAlign's scatter and the heads
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5


def uniforms(key, n):
    """The two [n] uniforms balanced_sample draws from ``key`` (positives,
    negatives), as numpy."""
    kp, kn = jax.random.split(key)
    return (np.array(jax.random.uniform(kp, (n,))), np.array(jax.random.uniform(kn, (n,))))


def batch_uniforms(key, b, n):
    """The uniforms of a batch whose per-image keys are split(key, b)."""
    per = [uniforms(k, n) for k in jax.random.split(key, b)]
    return tuple(torch.from_numpy(np.stack([p[i] for p in per])) for i in range(2))


# -- ops/matcher.py, ops/sampler.py -------------------------------------------

@pytest.mark.parametrize("low_quality", [False, True])
@pytest.mark.parametrize("thresholds", [(0.7, 0.3), (0.5, 0.5)])
def test_match_is_jax_s(low_quality, thresholds):
    rng = np.random.RandomState(0)
    q = (rng.randint(0, 20, (3, 7, 60)) / 20).astype(np.float32)  # many ties
    valid = rng.rand(3, 7) < 0.7
    valid[2] = False  # no valid GT at all
    q[0, 1, :5] = 0.95  # a GT best at five predictions
    for i in range(3):
        ref = JM.match(jnp.asarray(q[i]), jnp.asarray(valid[i]), *thresholds, low_quality)
        out = M.match(torch.from_numpy(q[i]), torch.from_numpy(valid[i]), *thresholds,
                      low_quality)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    batched = M.match(torch.from_numpy(q), torch.from_numpy(valid), *thresholds, low_quality)
    ref = jax.vmap(lambda a, b: JM.match(a, b, *thresholds, low_quality))(jnp.asarray(q),
                                                                          jnp.asarray(valid))
    np.testing.assert_array_equal(batched.numpy(), np.asarray(ref))
    assert set(np.unique(batched.numpy())) >= {-1} | ({-2} if thresholds[0] > thresholds[1]
                                                     else set())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_balanced_sample_takes_jax_s_sets_from_jax_s_draws(seed):
    rng = np.random.RandomState(seed)
    labels = rng.choice([-2, -1, 0, 0, 0, 1, 2], 300)
    key = jax.random.key(seed)
    pos_j, neg_j = JS.balanced_sample(jnp.asarray(labels), key, 64, 0.25)
    pos, neg = S.balanced_sample(torch.from_numpy(labels), 64, 0.25,
                                 tuple(torch.from_numpy(u) for u in uniforms(key, 300)))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(neg_j))
    assert int(pos.sum()) == 16 and int(neg.sum()) == 48


def test_topk_mask_by_score_breaks_ties_by_index():
    score = np.array([0.5, 0.9, 0.5, -np.inf, 0.5, 0.9, 0.1], np.float32)
    for k in range(8):
        ref = JS._topk_mask_by_score(jnp.asarray(score), jnp.asarray(k))
        out = S._topk_mask_by_score(torch.from_numpy(score), torch.tensor(k))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampler_draws_from_a_generator():
    labels = torch.from_numpy(np.random.RandomState(3).choice([-1, 0, 1], (2, 200)))
    a = S.balanced_sample(labels, 32, 0.5, generator=torch.Generator().manual_seed(5))
    b = S.balanced_sample(labels, 32, 0.5, generator=torch.Generator().manual_seed(5))
    c = S.balanced_sample(labels, 32, 0.5, generator=torch.Generator().manual_seed(6))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert bool(((a[0] | a[1]).sum(-1) == 32).all())


# -- models/rpn.py ------------------------------------------------------------

def rpn_inputs(seed, b=3, m=4, a=400):
    rng = np.random.RandomState(seed)
    xy = rng.rand(a, 2) * 56
    anchors = np.concatenate([xy, xy + rng.rand(a, 2) * 24 + 2], -1).astype(np.float32)
    gxy = rng.rand(b, m, 2) * 40
    gt = np.concatenate([gxy, gxy + rng.rand(b, m, 2) * 20 + 4], -1).astype(np.float32)
    gt[:, :2] = anchors[rng.randint(0, a, (b, 2))]  # GTs on anchors: IoU 1 matches
    valid = rng.rand(b, m) < 0.8
    valid[:, 0] = True
    valid[b - 1] = False  # a background image
    obj = rng.randn(b, a).astype(np.float32)
    deltas = (rng.randn(b, a, 4) * 0.3).astype(np.float32)
    return anchors, gt, valid, obj, deltas


def test_rpn_assignment_and_loss_match_jax():
    anchors, gt, valid, obj, deltas = rpn_inputs(4)
    b, a = obj.shape
    cfg = dataclasses.replace(TINY_RPN, batch_size_per_image=64)
    labels_j, boxes_j = jax.vmap(JRPN._assign_per_image, (0, 0, None, None))(
        jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(anchors), cfg)
    labels, boxes = RPN._assign_per_image(torch.from_numpy(gt), torch.from_numpy(valid),
                                          torch.from_numpy(anchors), port_rpn_config(cfg))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(labels_j))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(boxes_j))
    assert set(np.unique(labels.numpy())) == {-1.0, 0.0, 1.0}
    assert (labels[-1] == 0).all()  # the background image

    key = jax.random.key(7)
    ref = JRPN.rpn_loss(jnp.asarray(obj), jnp.asarray(deltas), jnp.asarray(anchors),
                        jnp.asarray(gt), jnp.asarray(valid), key, cfg)
    t_obj = torch.from_numpy(obj).requires_grad_()
    t_deltas = torch.from_numpy(deltas).requires_grad_()
    out = RPN.rpn_loss(t_obj, t_deltas, torch.from_numpy(anchors), torch.from_numpy(gt),
                       torch.from_numpy(valid), port_rpn_config(cfg), batch_uniforms(key, b, a))
    for k in ref:
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
        assert np.isfinite(out[k].item())
    # and the gradients, which reach only the sampled anchors
    grads = jax.grad(lambda o, d: sum(JRPN.rpn_loss(o, d, jnp.asarray(anchors), jnp.asarray(gt),
                                                    jnp.asarray(valid), key, cfg).values()),
                     argnums=(0, 1))(jnp.asarray(obj), jnp.asarray(deltas))
    sum(out.values()).backward()
    for t, g in zip((t_obj, t_deltas), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-7)
        np.testing.assert_array_equal(t.grad.numpy() != 0, np.asarray(g) != 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_training_filter_keeps_jax_s_sets(seed):
    rng = np.random.RandomState(seed)
    level_sizes = (16 * 16 * 3, 8 * 8 * 3, 4 * 4 * 3, 2 * 2 * 3, 1 * 1 * 3)
    total = sum(level_sizes)
    xy = rng.rand(2, total, 2).astype(np.float32) * 70 - 6
    props = np.concatenate([xy, xy + rng.rand(2, total, 2).astype(np.float32) * 30], -1)
    obj = rng.randn(2, total).astype(np.float32)
    # train and test settings apart, so that the flag is seen to pick them
    cfg = dataclasses.replace(TINY_RPN, pre_nms_top_n_train=128, post_nms_top_n_train=48)
    ref = [np.asarray(t) for t in JRPN.filter_proposals(
        jnp.asarray(props), jnp.asarray(obj), level_sizes, (IMG, IMG), cfg, training=True)]
    out = [t.numpy() for t in RPN.filter_proposals(
        torch.from_numpy(props), torch.from_numpy(obj), level_sizes, (IMG, IMG),
        port_rpn_config(cfg), training=True)]
    assert out[0].shape == (2, 48, 4)
    # the same proposals in the same (radix top-k) order
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-6)
    assert ref[2].all()  # 48 of the kept proposals survive in every image


# -- models/roi_heads.py ------------------------------------------------------

def roi_inputs(seed, b=3, p=40, m=5):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, p, 2) * 50
    props = np.concatenate([xy, xy + rng.rand(b, p, 2) * 30 + 1], -1).astype(np.float32)
    gxy = rng.rand(b, m, 2) * 40
    gt = np.concatenate([gxy, gxy + rng.rand(b, m, 2) * 25 + 4], -1).astype(np.float32)
    props[:, :m] = gt + rng.randn(b, m, 4).astype(np.float32)  # positives
    prop_valid = rng.rand(b, p) < 0.85
    labels = rng.randint(1, 5, (b, m))
    valid = rng.rand(b, m) < 0.8
    valid[:, 0] = True
    valid[b - 1] = False  # a background image
    return props, prop_valid, gt, labels, valid


@pytest.mark.parametrize("seed", [0, 1])
def test_select_training_samples_is_jax_s(seed):
    props, prop_valid, gt, labels, valid = roi_inputs(seed)
    b, p = prop_valid.shape
    m = gt.shape[1]
    cfg = dataclasses.replace(TINY_ROI, batch_size_per_image=16)
    key = jax.random.key(10 + seed)
    ref = [np.asarray(t) for t in JRH.select_training_samples(
        jnp.asarray(props), jnp.asarray(prop_valid), jnp.asarray(gt), jnp.asarray(labels),
        jnp.asarray(valid), key, cfg)]
    out = [t.numpy() for t in RH.select_training_samples(
        torch.from_numpy(props), torch.from_numpy(prop_valid), torch.from_numpy(gt),
        torch.from_numpy(labels), torch.from_numpy(valid), port_roi_config(cfg),
        batch_uniforms(key, b, p + m))]
    names = ("boxes", "labels", "reg_targets", "pos", "sampled", "matched")
    for name, o, r in zip(names, out, ref):
        if name == "reg_targets":
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(o, r, err_msg=name)
    assert out[3].any() and (out[4] & ~out[3]).any()
    assert not out[3][-1].any()  # the background image has no positive


@pytest.mark.parametrize("loss_type", ["ce", "bce", "focal_loss", "gombit", "gombit_fl"])
@pytest.mark.parametrize("weighted", [False, True])
def test_fastrcnn_loss_matches_jax(loss_type, weighted):
    rng = np.random.RandomState(5)
    b, s, c = 2, 12, 5
    logits = (rng.randn(b, s, c) * 3).astype(np.float32)
    reg = rng.randn(b, s, 4 * c).astype(np.float32)
    labels = rng.randint(0, c, (b, s))
    targets = rng.randn(b, s, 4).astype(np.float32)
    sampled = rng.rand(b, s) < 0.8
    weights = (rng.rand(c) + 0.5).astype(np.float32) if weighted else None
    cfg = dataclasses.replace(TINY_ROI, loss_type=loss_type)
    ref = JRH.fastrcnn_loss(jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(labels),
                            jnp.asarray(targets), jnp.asarray(sampled), cfg,
                            None if weights is None else jnp.asarray(weights))
    t_logits = torch.from_numpy(logits).requires_grad_()
    out = RH.fastrcnn_loss(t_logits, torch.from_numpy(reg), torch.from_numpy(labels),
                           torch.from_numpy(targets), torch.from_numpy(sampled),
                           port_roi_config(cfg),
                           None if weights is None else torch.from_numpy(weights))
    for k in ref:
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    out["loss_classifier"].backward()
    grad = jax.grad(lambda x: JRH.fastrcnn_loss(
        x, jnp.asarray(reg), jnp.asarray(labels), jnp.asarray(targets), jnp.asarray(sampled),
        cfg, None if weights is None else jnp.asarray(weights))["loss_classifier"])(
        jnp.asarray(logits))
    np.testing.assert_allclose(t_logits.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("norm", [0, 1, 2])
def test_training_tfidf_scale_and_gombit_match_jax(norm):
    rng = np.random.RandomState(6)
    labels = rng.randint(0, 5, (3, 4))
    valid = rng.rand(3, 4) < 0.6
    cfg = dataclasses.replace(TINY_ROI, tfidf_mini_batch=True, tfidf_norm=norm)
    np.testing.assert_allclose(
        RH.training_tfidf_scale(torch.from_numpy(labels), torch.from_numpy(valid),
                                port_roi_config(cfg)).numpy(),
        np.asarray(JRH.training_tfidf_scale(jnp.asarray(labels), jnp.asarray(valid), cfg)),
        rtol=1e-6)
    vec = np.linspace(0.5, 2, 5).astype(np.float32)
    assert RH.training_tfidf_scale(None, None, port_roi_config(TINY_ROI), vec) is vec
    assert RH.training_tfidf_scale(None, None, port_roi_config(TINY_ROI)) == 1.0
    x = np.linspace(-8, 10, 50).astype(np.float32)
    np.testing.assert_allclose(RH._gombit_prob(torch.from_numpy(x)).numpy(),
                               np.asarray(JRH._gombit_prob(jnp.asarray(x))), rtol=1e-6)


# -- models/faster_rcnn.py train=True, trainer.frcnn_train_step ---------------

@pytest.fixture(scope="module")
def tiny_train():
    """The tiny R(1,1,1,1)-FPN Faster R-CNN of the multichip dryrun at 64 px,
    batch 2 (the second image a background image), random frozen
    statistics: the JAX losses and gradients with the keys its samplers
    took, and the port model holding the same weights."""
    cfg = JF.FasterRCNNConfig(num_classes=5, rpn=TINY_RPN,
                              roi=dataclasses.replace(TINY_ROI, pooler_method="canvas"),
                              resnet_layers=(1, 1, 1, 1))
    model = JF.FasterRCNN(cfg)
    rng = np.random.RandomState(3)
    x = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    gt = np.array([[[4.0, 4.0, 24.0, 24.0], [30.0, 30.0, 50.0, 44.0], [0, 0, 0, 0]]] * 2,
                  np.float32)
    labels = np.array([[1, 3, 0]] * 2)
    valid = np.array([[True, True, False], [False, False, False]])
    v = jax.jit(lambda k, im: model.init(k, im, train=False))(jax.random.key(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["frozen"] = randomized_frozen(v["frozen"], 1)
    rng_key = jax.random.key(2)
    args = (jnp.asarray(x), jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid))
    keys = {}  # the keys the two samplers take, passed out of the trace

    def loss_fn(params):  # detection_main's: the four losses summed
        losses = model.apply({**v, "params": params}, *args, train=True,
                             rngs={"sampler": rng_key})
        return sum(jnp.asarray(t) for t in losses.values()), (losses, dict(keys))

    mp = pytest.MonkeyPatch()
    real_rpn, real_sel = JRPN.rpn_loss, JRH.select_training_samples
    mp.setattr(JRPN, "rpn_loss", lambda *a, **k: (keys.setdefault("rpn", a[5]),
                                                  real_rpn(*a, **k))[1])
    mp.setattr(JRH, "select_training_samples",
               lambda *a, **k: (keys.setdefault("roi", a[5]), real_sel(*a, **k))[1])
    try:
        (total, (losses, keys)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, v["params"]))
    finally:
        mp.undo()
    port = F.FasterRCNN(port_config(cfg))
    port.load_state_dict(flax_frcnn_to_torch(v["params"], v["frozen"]))
    a_total = sum(3 * (IMG // s) ** 2 for s in (4, 8, 16, 32)) + 3 * 1
    draws = {"rpn": batch_uniforms(keys["rpn"], 2, a_total),
             "roi": batch_uniforms(keys["roi"], 2, TINY_RPN.post_nms_top_n_train + 3)}
    return dict(cfg=cfg, model=model, v=v, port=port, x=x, gt=gt, labels=labels, valid=valid,
                total=float(total), losses={k: float(t) for k, t in losses.items()},
                grads=jax.tree_util.tree_map(np.asarray, grads), draws=draws, keys=keys)


def port_losses(t, port=None):
    port = port or t["port"]
    return port.train()(torch.from_numpy(t["x"]), torch.from_numpy(t["gt"]),
                        torch.from_numpy(t["labels"]), torch.from_numpy(t["valid"]),
                        train=True, uniforms=t["draws"])


def test_frcnn_train_losses_match_jax(tiny_train):
    t = tiny_train
    out = port_losses(t)
    assert sorted(out) == sorted(t["losses"])
    for k, ref in t["losses"].items():
        np.testing.assert_allclose(out[k].item(), ref, rtol=1e-4, err_msg=k)
        assert ref > 0


def test_frcnn_train_gradients_match_jax(tiny_train):
    t = tiny_train
    port = t["port"]
    port.zero_grad()
    sum(port_losses(t).values()).backward()
    ref = flax_frcnn_to_torch(t["grads"], {})
    named = dict(port.named_parameters())
    assert set(ref) == set(named)
    for k, g in ref.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    # the backbone's gradients passed through the pooler's backward
    assert named["backbone.resnet.layer1_block0.conv1.weight"].grad.abs().sum() > 0


def test_frcnn_train_step_updates_as_sgd(tiny_train):
    """One frcnn_train_step: the total loss of the JAX step, and the first
    SGD update (momentum 0.9, weight decay 1e-4 added to the gradient) at
    lr 0.0025: -lr (g + 1e-4 p) with the JAX gradients g. The update is
    compared within the gradients' tolerance, plus two f32 ulps of a
    parameter near 1."""
    t = tiny_train
    lr = 0.0025
    port = F.FasterRCNN(port_config(t["cfg"]))
    port.load_state_dict(t["port"].state_dict())
    tx = O.make_optimizer(O.OptimizerConfig("sgd", lr, 1e-4, 0.9),
                          O.SchedulerConfig("multistep", milestones=(16, 22)))
    state = T.create_frcnn_train_state(port, tx)
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    state, total, losses = T.frcnn_train_step(
        state, torch.from_numpy(t["x"]), torch.from_numpy(t["gt"]),
        torch.from_numpy(t["labels"]), torch.from_numpy(t["valid"]), uniforms=t["draws"])
    np.testing.assert_allclose(total.item(), t["total"], rtol=1e-4)
    assert sorted(losses) == sorted(t["losses"])
    ref = flax_frcnn_to_torch(t["grads"], {})
    for k, p in port.named_parameters():
        np.testing.assert_allclose((before[k] - p.detach()).numpy(),
                                   (lr * (ref[k] + 1e-4 * before[k])).numpy(), rtol=GRAD_RTOL,
                                   atol=lr * GRAD_ATOL + 2.5e-7, err_msg=k)
    assert state.step == 1 and state.optimizer.count == 1


def test_frcnn_train_draws_from_a_generator(tiny_train):
    t = tiny_train
    kw = dict(train=True, generator=None)
    args = (torch.from_numpy(t["x"]), torch.from_numpy(t["gt"]),
            torch.from_numpy(t["labels"]), torch.from_numpy(t["valid"]))
    port = t["port"].train()
    a = port(*args, **{**kw, "generator": torch.Generator().manual_seed(1)})
    b = port(*args, **{**kw, "generator": torch.Generator().manual_seed(1)})
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_training_forward_needs_training_mode(tiny_train):
    """In eval mode the backbone may take the fused forward-only blocks,
    which pass no gradient: train=True refuses an eval-mode model, and
    create_frcnn_train_state puts the model in training mode."""
    t = tiny_train
    port = F.FasterRCNN(port_config(t["cfg"]))
    port.load_state_dict(t["port"].state_dict())
    args = [torch.from_numpy(t[k]) for k in ("x", "gt", "labels", "valid")]
    with pytest.raises(ValueError, match="training mode"):
        port.eval()(*args, train=True, uniforms=t["draws"])
    state = T.create_frcnn_train_state(port, O.make_optimizer(O.OptimizerConfig(),
                                                              O.SchedulerConfig()))
    assert state.model.training
    T.frcnn_train_step(state, *args, uniforms=t["draws"])


def test_fold_cache_refolds_after_a_train_step():
    """A fused eval forward after an optimizer step folds the updated
    weights: the step changes the weights in place (their versions)."""
    cfg = F.FasterRCNNConfig(num_classes=5, rpn=port_rpn_config(TINY_RPN),
                             roi=port_roi_config(TINY_ROI), resnet_layers=(1, 1, 1, 1),
                             backbone_fused="interpret")
    model = F.init_frcnn_(F.FasterRCNN(cfg))
    block = model.backbone.resnet.layer1_block0
    x = torch.from_numpy(np.random.RandomState(4).randn(1, IMG, IMG, 3).astype(np.float32))
    model.dtype = torch.bfloat16
    model.eval()
    with torch.no_grad():
        model(x)
    first = block.prepared()
    assert block.uses_fused(torch.zeros(1, 64, 16, 16, dtype=torch.bfloat16))
    model.dtype = torch.float32
    state = T.create_frcnn_train_state(model, O.make_optimizer(
        O.OptimizerConfig("sgd", 0.01, 1e-4, 0.9), O.SchedulerConfig("multistep")))
    T.frcnn_train_step(state, x, torch.tensor([[[4.0, 4.0, 30.0, 40.0]]]),
                       torch.tensor([[2]]), torch.tensor([[True]]),
                       generator=torch.Generator().manual_seed(0))
    model.eval()
    model.dtype = torch.bfloat16
    with torch.no_grad():
        model(x)
    second = block.prepared()
    assert second is not first
    refolded = fold_bn(block.conv1.weight, dict(block.bn1.named_buffers()), block.bn1.eps)
    assert torch.equal(second.folded[0], refolded[0])
    assert not torch.equal(first.folded[0], second.folded[0])
