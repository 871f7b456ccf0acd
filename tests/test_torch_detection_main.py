"""The port's detection_main adapter (object_detectors_tpu_torch/
detection_main.py ModelAdapter, train/trainer.py detection_train_step) and
the RetinaNet loss (models/retinanet.py) against the JAX functions in
float32 on the CPU, on the same numpy-seeded inputs and weights moved by
utils/weights.py; and the coverage of the three new weight converters.

For each of the five architectures at ``small=True`` (ResNet (1, 1, 1, 1)):
``losses`` within rtol 1e-4 (the two-stage samplers' draws replayed from
the JAX keys), ``detect`` with identical kept sets, labels and valid flags
and boxes and scores within 1e-4, masks within 1e-4 and keypoints within
1e-3. One ``detection_train_step`` of the default model (RetinaNet) holds
the update of the JAX ``_train_step_impl`` (optax SGD with detection_main's
warmup) within the gradients' tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from object_detectors_tpu import detection_main as JDM
from object_detectors_tpu.models import keypoint_rcnn as JKR
from object_detectors_tpu.models import mask_rcnn as JMR
from object_detectors_tpu.models import retinanet as JRN
from object_detectors_tpu.models import ssd as JS
from object_detectors_tpu.train import optim as JO
from object_detectors_tpu_torch import detection_main as DM
from object_detectors_tpu_torch.models import retinanet as RN
from object_detectors_tpu_torch.models.mask_rcnn import MaskRCNN
from object_detectors_tpu_torch.models.keypoint_rcnn import KeypointRCNN
from object_detectors_tpu_torch.models.ssd import SSD300
from object_detectors_tpu_torch.train import optim as O
from object_detectors_tpu_torch.train import tiny_steps as TS
from object_detectors_tpu_torch.train import trainer as T
from object_detectors_tpu_torch.utils import weights as W
from test_torch_frcnn import _assert_detections_equal, randomized_frozen
from test_torch_frcnn_train import GRAD_ATOL, GRAD_RTOL
from test_torch_mask_rcnn import RCNN_SPECIAL, sampler_draws, seeded_params

CONVERTERS = {"fasterrcnn_resnet50_fpn": W.flax_frcnn_to_torch,
              "maskrcnn_resnet50_fpn": W.flax_maskrcnn_to_torch,
              "keypointrcnn_resnet50_fpn": W.flax_kprcnn_to_torch,
              "retinanet_resnet50_fpn": W.flax_retinanet_to_torch,
              "ssd300_vgg16": lambda params, frozen: W.flax_ssd_to_torch(params)}
SIZES = {"ssd300_vgg16": 300}
M_GT = 3  # the GT slots of tiny_steps.adapter_batch


# -- models/retinanet.py retinanet_loss -----------------------------------------

def retina_loss_inputs(seed, b=3, m=4, k=5):
    rng = np.random.RandomState(seed)
    xy = rng.rand(400, 2) * 56
    anchors = np.concatenate([xy, xy + 4 + rng.rand(400, 2) * 24], -1).astype(np.float32)
    gxy = rng.rand(b, m, 2) * 40
    gt = np.concatenate([gxy, gxy + 6 + rng.rand(b, m, 2) * 20], -1).astype(np.float32)
    gt[:, :2] = anchors[rng.randint(0, 400, (b, 2))]  # IoU 1 matches
    labels = rng.randint(0, k, (b, m))
    valid = rng.rand(b, m) < 0.8
    valid[:, 0] = True
    cls = (rng.randn(b, 400, k) * 2).astype(np.float32)
    reg = (rng.randn(b, 400, 4) * 0.3).astype(np.float32)
    return anchors, gt, labels, valid, cls, reg


@pytest.mark.parametrize("mini_batch, norm, tfidf", [(False, 0, 1.0), (False, 0, "vector"),
                                                      (True, 0, 1.0), (True, 1, 1.0)])
def test_retinanet_loss_and_gradients_match_jax(mini_batch, norm, tfidf):
    anchors, gt, labels, valid, cls, reg = retina_loss_inputs(0)
    cfg = JRN.RetinaNetConfig(num_classes=5, tfidf_mini_batch=mini_batch, tfidf_norm=norm)
    t = np.linspace(0.5, 2.0, 5).astype(np.float32) if tfidf == "vector" else tfidf
    args = (jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid))

    def jax_total(c, r):
        out = JRN.retinanet_loss(c, r, *args, cfg, tfidf=jnp.asarray(t))
        return out["classification"] + out["bbox_regression"], out

    (_, ref), grads = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    t_cls, t_reg = (torch.from_numpy(a).requires_grad_() for a in (cls, reg))
    port_cfg = RN.RetinaNetConfig(num_classes=5, tfidf_mini_batch=mini_batch, tfidf_norm=norm)
    out = RN.retinanet_loss(t_cls, t_reg, *[torch.from_numpy(a) for a in (anchors, gt, labels,
                                                                          valid)],
                            port_cfg, tfidf=torch.as_tensor(t))
    for k in ref:
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=1e-4, err_msg=k)
    sum(out.values()).backward()
    for g_port, g in zip((t_cls, t_reg), grads):
        np.testing.assert_allclose(g_port.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-8)
    matched = RN._match_per_image(*[torch.from_numpy(a) for a in (gt, valid, anchors)],
                                  port_cfg)
    ref_m = jax.vmap(JRN._match_per_image, (0, 0, None, None))(args[1], args[3], args[0], cfg)
    np.testing.assert_array_equal(matched.numpy(), np.asarray(ref_m))
    assert {-2, -1} <= set(np.unique(matched.numpy()))


def test_retinanet_train_forward_needs_training_mode():
    model = RN.init_retinanet_(RN.RetinaNet(5, (1, 1, 1, 1)))
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="training mode"):
        model.eval()(x, train=True)
    assert model.train()(x, train=True)[0].shape == (1, 9 * (64 + 16 + 4 + 1 + 1), 5)


# -- detection_main.ModelAdapter ---------------------------------------------------

def batch_for(name, size, seed=0):
    """``tiny_steps.adapter_batch`` as numpy: two normalized images, 3 GT
    slots (the second image one short), masks or keypoints."""
    return {k: t.numpy() for k, t in TS.adapter_batch(name, size, seed).items()}


def scale_class_scores(name, params):
    """Class scores spread apart so that detections pass the thresholds and
    are not near-tied (RetinaNet's prior bias lifted too)."""
    if name == "retinanet_resnet50_fpn":
        head = params["head"]["cls_logits"]
        head["kernel"], head["bias"] = head["kernel"] * 40.0, head["bias"] * 0 - 2.0
    elif name in DM.TWO_STAGE:
        params["box_predictor"]["cls_score"]["kernel"] *= 40.0
    else:
        for i in range(6):
            params["head"][f"cls{i}"]["kernel"] *= 40.0
    return params


OPT = ("sgd", 0.0025, 1e-4, 0.9)
SCHED = dict(name="multistep", milestones=(16, 22), warmup_steps=10, warmup_factor=1.0 / 1000)
_REFS = {}


def reference(name):
    """One jitted JAX call per architecture: seeded variables of the
    adapter's model (``seeded_params``, random frozen statistics,
    ``scale_class_scores``), its losses on
    ``batch_for(name, size)`` with the keys the two samplers took, its
    detections on the images of seed 1 (with masks or keypoints), and for
    RetinaNet ``_train_step_impl``'s first update on the batch of seed 2
    (optax SGD with detection_main's warmup). With the port's adapter on
    the CPU holding the same weights; made once per name."""
    if name in _REFS:
        return _REFS[name]
    from object_detectors_tpu.models import roi_heads as JRH
    from object_detectors_tpu.models import rpn as JRPN

    size = SIZES.get(name, 64)
    ncls = 2 if name.startswith("keypoint") else 5
    kw = dict(resnet_layers=(1, 1, 1, 1), small=True)
    jax_ad = JDM.ModelAdapter(name, ncls, size, **kw)
    shapes = jax.eval_shape(jax_ad.init_variables, jax.random.key(0))
    v = {"params": scale_class_scores(name, seeded_params(dict(shapes["params"]), 0,
                                                          {**RCNN_SPECIAL, "head": 0.01}))}
    if "frozen" in shapes:
        v["frozen"] = randomized_frozen(shapes["frozen"], 1)
    detect = {"maskrcnn_resnet50_fpn": jax_ad.detect_with_masks,
              "keypointrcnn_resnet50_fpn": jax_ad.detect_with_keypoints}.get(name, jax_ad.detect)
    batches = [{k: jnp.asarray(a) for k, a in batch_for(name, size, seed).items()}
               for seed in (0, 1, 2)]
    tx = JO.make_optimizer(JO.OptimizerConfig(*OPT), JO.SchedulerConfig(**SCHED), 10)
    keys = {}

    def run(v):
        out = {"losses": jax_ad.losses(v, batches[0], jax.random.key(4)),
               "det": detect(v, batches[1]["images"])}
        if name == "retinanet_resnet50_fpn":
            rest = {k: t for k, t in v.items() if k != "params"}

            def loss_fn(p):
                losses = jax_ad.losses({**rest, "params": p}, batches[2], None)
                return sum(jnp.asarray(t) for t in losses.values())

            out["total"], grads = jax.value_and_grad(loss_fn)(v["params"])
            out["grads"] = grads
            updates, _ = tx.update(grads, tx.init(v["params"]), v["params"])
            out["new_params"] = optax.apply_updates(v["params"], updates)
        return out, dict(keys)

    mp = pytest.MonkeyPatch()
    real_rpn, real_sel = JRPN.rpn_loss, JRH.select_training_samples
    mp.setattr(JRPN, "rpn_loss", lambda *a, **k: (keys.setdefault("rpn", a[5]),
                                                  real_rpn(*a, **k))[1])
    mp.setattr(JRH, "select_training_samples",
               lambda *a, **k: (keys.setdefault("roi", a[5]), real_sel(*a, **k))[1])
    try:
        ref, keys = jax.jit(run)(v)
    finally:
        mp.undo()
    ref = jax.tree_util.tree_map(np.asarray, ref)
    port = DM.ModelAdapter(name, ncls, size, device="cpu", **kw)
    port.model.load_state_dict(CONVERTERS[name](v["params"], v.get("frozen", {})))
    draws = (sampler_draws(keys, 2, size, 32, M_GT) if name in DM.TWO_STAGE else None)
    _REFS[name] = (ref, port, size, draws)
    return _REFS[name]


@pytest.mark.parametrize("name", DM.MODELS)
def test_adapter_losses_match_jax(name):
    ref, port, size, draws = reference(name)
    batch = batch_for(name, size)
    out = port.losses({k: torch.from_numpy(a) for k, a in batch.items()}, uniforms=draws)
    assert sorted(out) == sorted(ref["losses"])
    for k, r in ref["losses"].items():
        np.testing.assert_allclose(out[k].item(), float(r), rtol=1e-4, err_msg=k)
    assert port.model.training


@pytest.mark.parametrize("name", DM.MODELS)
def test_adapter_detect_matches_jax(name):
    ref, port, size, _ = reference(name)
    x = torch.from_numpy(batch_for(name, size, seed=1)["images"])
    det = ref["det"]
    out = port.detect(x)
    _assert_detections_equal(out, det[:4])
    assert out[3].any() and not port.model.training
    if name == "maskrcnn_resnet50_fpn":
        out = port.detect_with_masks(x)
        _assert_detections_equal(out[:4], det[:4])
        np.testing.assert_allclose(out[4].numpy(), det[4], rtol=1e-4, atol=1e-4)
    if name == "keypointrcnn_resnet50_fpn":
        out = port.detect_with_keypoints(x)
        _assert_detections_equal(out[:4], det[:4])
        np.testing.assert_allclose(out[4].numpy(), det[4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(out[5].numpy(), det[5], rtol=1e-4, atol=1e-4)


def test_adapter_checks_its_name_and_device():
    with pytest.raises(ValueError):
        DM.ModelAdapter("yolov3", 5, 64, device="cpu")
    port = reference("fasterrcnn_resnet50_fpn")[1]
    with pytest.raises(ValueError, match="maskrcnn"):
        port.detect_with_masks(torch.zeros(1, 64, 64, 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DM.ModelAdapter("ssd300_vgg16", 5, 300)


def test_detection_train_step_updates_as_train_step_impl():
    """detection_main's default model: one detection_train_step against the
    JAX ``_train_step_impl`` (the losses summed, value_and_grad, optax SGD
    0.0025 with momentum 0.9, weight decay 1e-4 and the linear warmup from
    1/1000): every parameter's gradient within GRAD_RTOL / GRAD_ATOL, and
    the update within the gradients' tolerance plus two f32 ulps of a
    parameter near 1."""
    name = "retinanet_resnet50_fpn"
    ref, trained, size, _ = reference(name)
    port = DM.ModelAdapter(name, 5, size, resnet_layers=(1, 1, 1, 1), small=True, device="cpu")
    port.model.load_state_dict(trained.model.state_dict())
    state = T.create_detection_train_state(port, O.make_optimizer(
        O.OptimizerConfig(*OPT), O.SchedulerConfig(**SCHED), 10))
    before = {k: p.detach().clone() for k, p in port.model.named_parameters()}
    batch = batch_for(name, size, seed=2)
    state, total, losses = T.detection_train_step(
        state, port, {k: torch.from_numpy(a) for k, a in batch.items()})
    np.testing.assert_allclose(total.item(), float(ref["total"]), rtol=1e-4)
    assert sorted(losses) == ["bbox_regression", "classification"] and state.step == 1
    ref_grads = W.flax_retinanet_to_torch(ref["grads"], {})
    named = dict(port.model.named_parameters())
    assert set(ref_grads) == set(named)
    for k, g in ref_grads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    assert named["backbone.resnet.conv1.weight"].grad.abs().sum() > 0
    ref_new = W.flax_retinanet_to_torch(ref["new_params"], {})
    lr = 0.0025 / 1000
    for k, p in port.model.named_parameters():
        np.testing.assert_allclose((p.detach() - before[k]).numpy(),
                                   (ref_new[k] - before[k]).numpy(), rtol=GRAD_RTOL,
                                   atol=lr * GRAD_ATOL + 2.5e-7, err_msg=k)
    assert any(not torch.equal(p.detach(), before[k]) for k, p in port.model.named_parameters())


# -- utils/weights.py: every Flax leaf mapped once, every tensor filled -------------

def _zeros_like_shapes(tree):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)


@pytest.mark.parametrize("name", ["maskrcnn", "kprcnn", "ssd"])
def test_converter_covers_the_full_width_model(name):
    """Full-width models (ResNet-50, 91 classes; the 8 x 512 keypoint head;
    VGG16) from their shapes alone: each Flax leaf becomes one tensor of the
    port's state dict, of its shape, and every tensor is filled; a leaf
    left over raises."""
    if name == "maskrcnn":
        model, port = JMR.MaskRCNN(JMR.MaskRCNNConfig()), MaskRCNN()
        convert = W.flax_maskrcnn_to_torch
    elif name == "kprcnn":
        model, port = JKR.KeypointRCNN(JKR.KeypointRCNNConfig()), KeypointRCNN()
        convert = W.flax_kprcnn_to_torch
    else:
        model, port = JS.SSD300(JS.SSDConfig()), SSD300()
        convert = lambda params, frozen: W.flax_ssd_to_torch(params)  # noqa: E731
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 300, 300, 3)),
                                               train=False))
    v = {k: _zeros_like_shapes(dict(t)) for k, t in shapes.items()}
    state = convert(v["params"], v.get("frozen", {}))
    leaves = sum(len(jax.tree_util.tree_leaves(t)) for t in v.values())
    assert len(state) == leaves
    want = port.state_dict()
    assert set(state) == set(want)
    for k, t in state.items():
        assert t.shape == want[k].shape, k
    port.load_state_dict(state)  # strict
    extra = jax.tree_util.tree_map(lambda a: a, v["params"])
    extra["backbone"] = {**extra["backbone"], "stray": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="stray"):
        convert(extra, v.get("frozen", {}))


def test_converter_flips_transposed_kernels_and_keeps_scale_weight():
    rng = np.random.RandomState(11)
    k = rng.randn(4, 4, 3, 5).astype(np.float32)
    state = W.flax_kprcnn_to_torch({"kp_predictor": {"kps_score_lowres": {
        "kernel": k, "bias": np.zeros(5, np.float32)}}}, {})
    np.testing.assert_array_equal(state["kp_predictor.kps_score_lowres.weight"].numpy(),
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))
    k2 = rng.randn(2, 2, 3, 5).astype(np.float32)
    state = W.flax_maskrcnn_to_torch({"mask_predictor": {"conv5_mask": {"kernel": k2}}}, {})
    np.testing.assert_array_equal(state["mask_predictor.conv5_mask.weight"].numpy(),
                                  k2[::-1, ::-1].transpose(2, 3, 0, 1))
    scale = rng.rand(512).astype(np.float32)
    state = W.flax_ssd_to_torch({"backbone": {"scale_weight": scale}})
    np.testing.assert_array_equal(state["backbone.scale_weight"].numpy(), scale)
    with pytest.raises(KeyError, match="scale_weight"):
        W.flax_frcnn_to_torch({"backbone": {"scale_weight": scale}}, {})
