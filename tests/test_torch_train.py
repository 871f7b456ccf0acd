"""The port's YOLO training (object_detectors_tpu_torch/models/yolo_criterion.py
``yolo_loss``, the train-mode ``ConvBN``, train/optim.py and
train/trainer.py) against the JAX functions, in float32 on the CPU with the
same numpy-seeded inputs and the same weights moved by utils/weights.py.

Tolerances: the loss, sub-losses and stats within rtol 1e-5 for one call
(the same formulas) and within rtol 1e-4 for two train steps (XLA and
PyTorch sum the convolutions in other orders, and the first update carries
that difference into the second step); learning rates within rtol 1e-6
and 1e-6 of the base rate (optax evaluates its schedules in f32, and
the warmup's (init - end) * frac + end rounds at the base rate's ulp);
the two steps' update of each parameter and batch statistic within
UPDATE_SHARE of that tensor's largest update."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from object_detectors_tpu.models import common as jax_common
from object_detectors_tpu.models import yolo_criterion as JYC
from object_detectors_tpu.models.yolo import YoloHead as FlaxYoloHead
from object_detectors_tpu.train import optim as JO
from object_detectors_tpu.train import trainer as JT
from object_detectors_tpu_torch.models import common as C
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.models.yolo import YoloHead
from object_detectors_tpu_torch.ops import matcher as MT
from object_detectors_tpu_torch.train import optim as O
from object_detectors_tpu_torch.train import trainer as T
from object_detectors_tpu_torch.utils.weights import flax_yolo_to_torch
from test_torch_yolo import randomize_bn

NUM_CLASSES = 4
IMG = 64
GRIDS = (2, 4, 8)
# the update of each parameter and running statistic by two SGD steps (in
# float64, see two_steps), as a share of that tensor's largest update: the
# loss is float32 in both trainers, so the gradients differ in their float32
# digits (3.2e-7 of a tensor's largest update seen)
UPDATE_SHARE = 1e-5


def port_cfg(cfg) -> YC.YoloLossConfig:
    return YC.YoloLossConfig(**dataclasses.asdict(cfg))


def loss_inputs(seed, b=3, m=5):
    rng = np.random.RandomState(seed)
    p = sum(g * g * 3 for g in GRIDS)
    raw = (rng.randn(b, p, 5 + NUM_CLASSES) * 1.5).astype(np.float32)
    xy = rng.rand(b, m, 2) * 0.8 + 0.1
    wh = rng.rand(b, m, 2) * 0.5 + 0.02
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, (b, m))
    valid = rng.rand(b, m) < 0.7
    valid[0] = False  # an image without GT (background)
    valid[1, 0] = True
    return raw, boxes, labels, valid


CASES = {
    "ce": {},
    "bce": {"class_loss": JYC.CLASS_LOSS_BCE},
    "eq": {"class_loss": JYC.CLASS_LOSS_EQ},
    "ce tfidf_batch": {"tfidf_batch": True},
    "bce tfidf_batch l2": {"class_loss": JYC.CLASS_LOSS_BCE, "tfidf_batch": True,
                           "tfidf_norm": 2},
    "eq tfidf_batch l1, CIoU": {"class_loss": JYC.CLASS_LOSS_EQ, "tfidf_batch": True,
                                "tfidf_norm": 1, "iou_type": 3},
    "ce, IoU, mean": {"iou_type": 0, "reduction": "mean"},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("weighted", [False, True])
def test_yolo_loss_matches_jax(case, weighted):
    cfg = JYC.YoloLossConfig(num_classes=NUM_CLASSES, img_size=IMG, **CASES[case])
    raw, boxes, labels, valid = loss_inputs(1)
    pj, gj = JYC.make_priors(cfg, GRIDS)
    pt, gt = YC.make_priors(port_cfg(cfg), GRIDS)
    rng = np.random.RandomState(2)
    extra_np = {}
    if weighted:
        extra_np["class_weights"] = (rng.rand(NUM_CLASSES) + 0.5).astype(np.float32)
        extra_np["idf_logits"] = (rng.rand(NUM_CLASSES) + 0.5).astype(np.float32)
    if cfg.class_loss == JYC.CLASS_LOSS_EQ:
        extra_np["eq_rare_mask"] = np.array([1, 0, 1, 0], np.float32)
    extra_j = {k: jnp.asarray(v) for k, v in extra_np.items()}

    def jax_loss(x):
        loss, sub, stats = JYC.yolo_loss(x, pj, gj, jnp.asarray(boxes), jnp.asarray(labels),
                                         jnp.asarray(valid), cfg, **extra_j)
        return loss, (sub, stats)

    (loss_j, (sub_j, stats_j)), grad_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(raw))
    t_raw = torch.from_numpy(raw).requires_grad_()
    out = YC.yolo_loss(t_raw, pt, gt, torch.from_numpy(boxes), torch.from_numpy(labels),
                       torch.from_numpy(valid), port_cfg(cfg),
                       **{k: torch.from_numpy(v) for k, v in extra_np.items()})
    for o, r in zip(out, (loss_j, sub_j, stats_j)):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    assert not out[2].requires_grad
    # and the gradient with respect to the raw predictions
    out[0].backward()
    np.testing.assert_allclose(t_raw.grad.numpy(), np.asarray(grad_j), rtol=1e-4, atol=1e-6)


def test_targets_best_prior_and_ignore_mask_are_jax_s():
    cfg = JYC.YoloLossConfig(num_classes=NUM_CLASSES, img_size=IMG)
    _, boxes, _, valid = loss_inputs(3, b=4, m=8)
    pj, gj = JYC.make_priors(cfg, GRIDS)
    pt, gt = YC.make_priors(port_cfg(cfg), GRIDS)
    best_j, tgt_j, noobj_j = jax.vmap(JYC._per_image_targets, (0, 0, None, None, None))(
        jnp.asarray(boxes), jnp.asarray(valid), pj, gj, cfg)
    best, tgt, noobj = YC._per_image_targets(torch.from_numpy(boxes), torch.from_numpy(valid),
                                             pt, gt, port_cfg(cfg))
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(noobj.numpy(), np.asarray(noobj_j))
    assert 0 < int(noobj.sum()) < noobj.numel()
    np.testing.assert_allclose(tgt.numpy(), np.asarray(tgt_j), rtol=1e-5, atol=1e-6)
    # yolo_best_prior_match is the same assignment, image by image
    from object_detectors_tpu.ops import matcher as JM
    for i in range(boxes.shape[0]):
        np.testing.assert_array_equal(
            MT.yolo_best_prior_match(torch.from_numpy(boxes[i]), pt, cfg.iou_type).numpy(),
            np.asarray(JM.yolo_best_prior_match(jnp.asarray(boxes[i]), pj, cfg.iou_type)))


def test_train_batch_norm_is_flax_s_with_the_biased_running_variance():
    """At n = 8 per channel the unbiased variance is 8/7 of the biased one:
    the running variance after one update tells them apart."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 2, 2, 3) * 2 + 1).astype(np.float32)  # NHWC, n = 8
    flax_bn = jax_common.ConvBN(5, 3)
    v = flax_bn.init(jax.random.key(0), jnp.asarray(x))
    v = randomize_bn({"params": {"bn": v["params"]["bn"], "conv": v["params"]["conv"]},
                      "batch_stats": v["batch_stats"]}, 5)
    y, new = flax_bn.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    m = C.ConvBN(3, 5, 3)
    m.load_state_dict(flax_yolo_to_torch(v["params"], v["batch_stats"]))
    out = m(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.bn.running_mean.numpy(), np.asarray(new["batch_stats"]["bn"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.bn.running_var.numpy(), np.asarray(new["batch_stats"]["bn"]["var"]),
                               rtol=1e-6, atol=1e-7)
    # eval mode leaves the statistics alone
    before = m.bn.running_var.clone()
    m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(m.bn.running_var, before)


def test_train_batch_norm_of_bf16_activations_keeps_f32_statistics():
    m = C.ConvBN(3, 4, 1)
    x = torch.randn(2, 3, 4, 4).to(torch.bfloat16)
    out = m(x, train=True)
    assert out.dtype == torch.bfloat16 and m.bn.running_var.dtype == torch.float32
    assert torch.isfinite(m.bn.running_var).all()


SCHEDULES = {
    "step": O.SchedulerConfig("step", step_size=2, factor=0.5),
    "multistep": O.SchedulerConfig("multistep", milestones=(1, 3), factor=0.1),
    "multistep warmup": O.SchedulerConfig("multistep", milestones=(2,), warmup_steps=4,
                                          warmup_factor=0.001),
    "cyclic": O.SchedulerConfig("cyclic", base_lr=1e-4, max_lr=1e-3, cycle_steps=6),
    "cyclic warmup": O.SchedulerConfig("cyclic", base_lr=1e-4, max_lr=1e-3, cycle_steps=5,
                                       warmup_steps=3, warmup_factor=0.1),
    "reduce_on_plateau": O.SchedulerConfig("reduce_on_plateau"),
    "step warmup": O.SchedulerConfig("step", step_size=1, warmup_steps=2),
}


def jax_sched_cfg(cfg: O.SchedulerConfig) -> JO.SchedulerConfig:
    return JO.SchedulerConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_make_schedule(name):
    opt = O.OptimizerConfig("sgd", 2e-3)
    ours = O.make_schedule(opt, SCHEDULES[name], steps_per_epoch=2)
    ref = JO.make_schedule(JO.OptimizerConfig(**dataclasses.asdict(opt)),
                           jax_sched_cfg(SCHEDULES[name]), 2)
    for step in range(16):
        np.testing.assert_allclose(ours(step), float(ref(jnp.asarray(step))), rtol=1e-6,
                                   atol=1e-6 * opt.lr)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("name", ["multistep warmup", "cyclic", "reduce_on_plateau"])
def test_optimizer_updates_match_optax(opt_name, name):
    """The first update takes schedule(0); the plateau scale multiplies the
    whole update, weight decay included."""
    opt = O.OptimizerConfig(opt_name, 1e-2, weight_decay=0.05, momentum=0.9)
    rng = np.random.RandomState(6)
    p0 = rng.randn(5).astype(np.float32)
    grads = [rng.randn(5).astype(np.float32) for _ in range(6)]
    tx = JO.make_optimizer(JO.OptimizerConfig(**dataclasses.asdict(opt)),
                           jax_sched_cfg(SCHEDULES[name]), 1)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ours = O.make_optimizer(opt, SCHEDULES[name], 1)([param])
    for i, g in enumerate(grads):
        if i == 3:  # a plateau: the scale drops
            state.hyperparams["plateau_scale"] = jnp.asarray(0.1)
            ours.plateau_scale = 0.1
        lr = ours.schedule(ours.count)
        assert ours.lr == lr * ours.plateau_scale
        updates, state = tx.update(jnp.asarray(g), state, pj)
        # the rate optax took for this update (the schedule at the count before it)
        np.testing.assert_allclose(lr, float(state.hyperparams["learning_rate"]), rtol=1e-6,
                                   atol=1e-6 * opt.lr)
        pj = optax.apply_updates(pj, updates)
        param.grad = torch.from_numpy(g)
        ours.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(pj), rtol=1e-5, atol=1e-7)
    assert ours.count == len(grads)


def test_multiscale_sizes_and_pick_scale():
    assert T.multiscale_sizes(416) == JT.multiscale_sizes(416)
    assert T.multiscale_sizes(320, 0.8, 1.2, 64) == JT.multiscale_sizes(320, 0.8, 1.2, 64)
    sizes = T.multiscale_sizes(416)
    draws = [T.pick_scale(torch.Generator().manual_seed(s), sizes) for s in range(40)]
    assert set(draws) <= set(sizes) and len(set(draws)) > 3
    assert draws == [T.pick_scale(torch.Generator().manual_seed(s), sizes) for s in range(40)]


def run_steps(steps: int, dtype):
    """``steps`` yolo_train_steps of the tiny YoloHead at 64 px, JAX and
    port, from the same weights and running statistics: SGD at 1e-3 with
    momentum 0.9, weight decay 5e-4 and a two-step warmup from half the
    rate. The network, its parameters and the optimizer run in ``dtype``
    (float32 or float64); the loss is float32 in both trainers."""
    f64 = dtype == "float64"
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32, torch.float32)
    cfg = JYC.YoloLossConfig(num_classes=NUM_CLASSES, img_size=IMG)
    opt = O.OptimizerConfig("sgd", 1e-3, 5e-4, 0.9)
    sch = O.SchedulerConfig("multistep", milestones=(10,), warmup_steps=2, warmup_factor=0.5)
    with jax.enable_x64(f64):
        flax_model = FlaxYoloHead(num_classes=NUM_CLASSES, backbone_layers=(1, 1, 1, 1, 1),
                                  dtype=jdt)
        tx = JO.make_optimizer(JO.OptimizerConfig(**dataclasses.asdict(opt)),
                               jax_sched_cfg(sch))
        v = jax.jit(lambda k: flax_model.init(k, jnp.zeros((1, IMG, IMG, 3), jdt),
                                              train=False))(jax.random.key(0))
        v = randomize_bn(v, 7)
        jstate = JT.TrainState.create(
            flax_model.apply, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), v["params"]),
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), v["batch_stats"]), tx)
        model = YoloHead(NUM_CLASSES, 3, (1, 1, 1, 1, 1), dtype=tdt)
        model.load_state_dict(flax_yolo_to_torch(v["params"], v["batch_stats"]))
        state = T.create_yolo_train_state(model.to(tdt), O.make_optimizer(opt, sch))
        state.initial = {k: v.clone() for k, v in model.state_dict().items()}
        state.initial_jax = v

        rng = np.random.RandomState(8)
        metrics = []
        for _ in range(steps):
            x = rng.rand(2, IMG, IMG, 3)
            boxes = np.concatenate([rng.rand(2, 6, 2) * 0.6 + 0.2,
                                    rng.rand(2, 6, 2) * 0.4 + 0.05], -1).astype(np.float32)
            labels = rng.randint(0, NUM_CLASSES, (2, 6))
            valid = rng.rand(2, 6) < 0.7
            jstate, jm = JT.yolo_train_step(jstate, jnp.asarray(x, jdt), jnp.asarray(boxes),
                                            jnp.asarray(labels), jnp.asarray(valid), cfg,
                                            NUM_CLASSES)
            state, m = T.yolo_train_step(state, torch.from_numpy(x).to(tdt),
                                         torch.from_numpy(boxes), torch.from_numpy(labels),
                                         torch.from_numpy(valid), port_cfg(cfg), NUM_CLASSES)
            metrics.append((jax.tree_util.tree_map(np.asarray, jm), m))
        jstate = jstate.replace(params=jax.tree_util.tree_map(np.asarray, jstate.params),
                                batch_stats=jax.tree_util.tree_map(np.asarray,
                                                                   jstate.batch_stats))
    return jstate, state, metrics


@pytest.fixture(scope="module")
def two_steps():
    """Two steps in float64: the kinks of leaky_relu (slope 0.1) make a
    float32 gradient jump where an activation within float32 noise of zero
    lands on the other side in one framework, and every later layer and step
    carries that (see test_one_yolo_train_step_in_float32_matches_jax);
    float64 keeps both programs on the same side of every kink, so the two
    steps hold the algorithm (train-mode batch norm, loss, gradients, SGD
    with warmup) tight."""
    return run_steps(2, "float64")


def test_two_yolo_train_steps_metrics_match_jax(two_steps):
    _, state, metrics = two_steps
    assert state.step == 2 and state.optimizer.count == 2
    for jm, m in metrics:
        for key in ("loss", "sub_losses", "stats", "grad_norm"):
            np.testing.assert_allclose(m[key].double().numpy(), jm[key], rtol=1e-4, atol=1e-6,
                                       err_msg=key)


def test_two_yolo_train_steps_parameters_and_batch_stats_match_jax(two_steps):
    """Each tensor's update by the two steps, p - p0, against JAX's, within
    UPDATE_SHARE of that tensor's largest update; every tensor moved, so a
    missing or wrong update fails."""
    jstate, state, _ = two_steps
    v = state.initial_jax

    def moved(a, b):
        return np.asarray(a, np.float64) - np.asarray(b, np.float64)

    # the JAX updates in float64, rounded to float32 only by the converter
    # (2^-24 of each, far inside UPDATE_SHARE)
    ref = flax_yolo_to_torch(jax.tree_util.tree_map(moved, jstate.params, v["params"]),
                             jax.tree_util.tree_map(moved, jstate.batch_stats, v["batch_stats"]))
    ours = state.model.state_dict()
    compared = 0
    for key, upd_ref in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        upd = ours[key].double() - state.initial[key].double()
        largest = upd_ref.double().abs().max().item()
        assert largest > 0, key
        np.testing.assert_allclose(upd.numpy(), upd_ref.double().numpy(), rtol=0,
                                   atol=UPDATE_SHARE * largest, err_msg=key)
        compared += 1
    assert compared == sum(1 for k in ours if not k.endswith("num_batches_tracked"))
    # the running statistics moved (by Flax's biased update, as compared)
    key = "backbone.stage5_block0.conv2.bn.running_var"
    assert not torch.allclose(ours[key], state.initial[key].to(ours[key].dtype))


def test_one_yolo_train_step_in_float32_matches_jax():
    """In float32 the loss, sub-losses and stats of a step hold to rtol 1e-4;
    grad_norm to rtol 1e-3: activations that XLA and PyTorch (their
    convolutions summed in other orders) put on the two sides of a
    leaky_relu kink take derivatives 1 and 0.1, and the batch norms of this
    tiny batch (8 to 2048 values a channel) spread each such flip over a
    channel."""
    _, state, metrics = run_steps(1, "float32")
    jm, m = metrics[0]
    for key in ("loss", "sub_losses", "stats"):
        np.testing.assert_allclose(m[key].numpy(), jm[key], rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(m["grad_norm"].numpy(), jm["grad_norm"], rtol=1e-3)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_eval_step_decodes_as_jax(two_steps):
    jstate, state, _ = two_steps
    cfg = JYC.YoloLossConfig(num_classes=NUM_CLASSES, img_size=IMG)
    x = np.random.RandomState(9).rand(1, IMG, IMG, 3)
    with jax.enable_x64(True):
        ref = JT.yolo_eval_step(jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(x),
                                cfg, NUM_CLASSES)
    out = T.yolo_eval_step(state, torch.from_numpy(x), port_cfg(cfg), NUM_CLASSES)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
