"""The port's Mask R-CNN (object_detectors_tpu_torch/models/mask_rcnn.py)
against the JAX MaskRCNN in float32 on the CPU, on the same numpy-seeded
inputs and weights moved by utils/weights.py: the heads, the target
projection, the loss and its gradients, the inference and the paste, the
tiny model in eval and training (the samplers' draws replayed from the
keys the jitted JAX step took), and the trained
``artifacts/synthetic_maskrcnn.msgpack`` at 96 px.

Kept sets, labels and valid flags must be identical; losses within rtol
1e-4, the whole model's gradients within rtol 1e-3 / atol 1e-5 (float32
sums in other orders through ResNet-FPN and both poolers' backwards);
mask targets and probabilities within the RoIAlign tests' rtol 1e-4 /
atol 1e-5 (1e-4 after the trained network's convolutions)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.models import mask_rcnn as JMR
from object_detectors_tpu.models import roi_heads as JRH
from object_detectors_tpu.models import rpn as JRPN
from object_detectors_tpu_torch.models import mask_rcnn as MR
from object_detectors_tpu_torch.utils.weights import flax_maskrcnn_to_torch
from test_torch_frcnn import _assert_detections_equal, port_roi_config, port_rpn_config
from test_torch_frcnn import randomized_frozen
from test_torch_frcnn_train import GRAD_ATOL, GRAD_RTOL, batch_uniforms

ROOT = Path(__file__).resolve().parent.parent
IMG = 64
# tests/test_mask_ssd.py's tiny Mask R-CNN, at the model's own 14x14 mask pooler
TINY_RPN = JRPN.RPNConfig(pre_nms_top_n_train=32, pre_nms_top_n_test=32,
                          post_nms_top_n_train=16, post_nms_top_n_test=8,
                          batch_size_per_image=16)
TINY_ROI = JRH.RoIHeadsConfig(num_classes=5, batch_size_per_image=8, detections_per_img=4,
                              pooler_method="canvas")


def port_mask_config(cfg) -> MR.MaskRCNNConfig:
    return MR.MaskRCNNConfig(num_classes=cfg.num_classes, rpn=port_rpn_config(cfg.rpn),
                             roi=port_roi_config(cfg.roi), resnet_layers=cfg.resnet_layers,
                             mask_pool_size=cfg.mask_pool_size)


# Flax's init scales of the R-CNN heads (the rest LeCun-normal)
RCNN_SPECIAL = {"rpn_head": 0.01, "cls_score": 0.01, "bbox_pred": 0.001}


def seeded_params(shapes, seed, special=None, bias_std=0.0):
    """numpy parameters of these shapes (``jax.eval_shape`` of an init, so
    that no init is compiled): kernels normal at LeCun scale (fan-in the
    product of all but the last axis), or at ``special[name]`` under a
    module of that name; other leaves (biases, SSD's ``scale_weight``)
    normal ``bias_std``."""
    rng = np.random.RandomState(seed)
    special = special or {}

    def leaf(path, s):
        names = [p.key for p in path]
        if names[-1] != "kernel":
            return (rng.randn(*s.shape) * bias_std).astype(np.float32)
        std = next((special[n] for n in reversed(names) if n in special),
                   float(np.prod(s.shape[:-1])) ** -0.5)
        return (rng.randn(*s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_train_with_keys(model, v, args, key, eval_images=None, **kw):
    """``detection_main``'s loss: the JAX model's losses summed, jitted with
    their gradients (and, given ``eval_images``, the eval outputs, in the
    same compile), and the keys the RPN and RoI samplers took (passed out
    of the trace). -> (total, losses, grads, keys, eval outputs or None)."""
    keys = {}

    def loss_fn(params):
        losses = model.apply({**v, "params": params}, *args, train=True,
                             rngs={"sampler": key}, **kw)
        return sum(jnp.asarray(t) for t in losses.values()), (losses, dict(keys))

    def step(params):
        out = jax.value_and_grad(loss_fn, has_aux=True)(params)
        ev = (None if eval_images is None
              else model.apply({**v, "params": params}, eval_images, train=False))
        return out, ev

    mp = pytest.MonkeyPatch()
    real_rpn, real_sel = JRPN.rpn_loss, JRH.select_training_samples
    mp.setattr(JRPN, "rpn_loss", lambda *a, **k: (keys.setdefault("rpn", a[5]),
                                                  real_rpn(*a, **k))[1])
    mp.setattr(JRH, "select_training_samples",
               lambda *a, **k: (keys.setdefault("roi", a[5]), real_sel(*a, **k))[1])
    try:
        ((total, (losses, keys)), grads), ev = jax.jit(step)(
            jax.tree_util.tree_map(jnp.asarray, v["params"]))
    finally:
        mp.undo()
    return (float(total), {k: float(t) for k, t in losses.items()},
            jax.tree_util.tree_map(np.asarray, grads), keys, ev)


def sampler_draws(keys, b, img, post_nms, m):
    """The port's uniforms for the two samplers, from the JAX keys."""
    a_total = sum(3 * (img // s) ** 2 for s in (4, 8, 16, 32)) + 3 * (-(-img // 64)) ** 2
    return {"rpn": batch_uniforms(keys["rpn"], b, a_total),
            "roi": batch_uniforms(keys["roi"], b, post_nms + m)}


# -- heads, targets, loss, inference, paste ------------------------------------

def test_mask_heads_and_predictor_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 14, 14, 32).astype(np.float32)
    head, pred = JMR.MaskRCNNHeads(features=32), JMR.MaskRCNNPredictor(5, features=32)
    vh = head.init(jax.random.key(0), jnp.asarray(x))
    feat = head.apply(vh, jnp.asarray(x))
    vp = pred.init(jax.random.key(1), feat)
    params = {"mask_head": dict(vh["params"]), "mask_predictor": dict(vp["params"])}
    # biases away from their zero init, so that a dropped bias shows
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.randn(*a.shape).astype(
        np.float32) * 0.1, params)
    ref = pred.apply({"params": params["mask_predictor"]},
                     head.apply({"params": params["mask_head"]}, jnp.asarray(x)))
    port = torch.nn.ModuleDict({"mask_head": MR.MaskRCNNHeads(32, 4, 32),
                                "mask_predictor": MR.MaskRCNNPredictor(5, 32, 32)})
    port.load_state_dict(flax_maskrcnn_to_torch(params, {}))
    with torch.no_grad():
        out = port["mask_predictor"](port["mask_head"](torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert out.shape == (3, 5, 28, 28)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def mask_inputs(seed, b=2, m=3, s=12, size=40, c=4):
    rng = np.random.RandomState(seed)
    masks = (rng.rand(b, m, size, size) < 0.4).astype(np.float32)
    masks[:, 0, 5:20, 8:30] = 1.0
    xy = rng.rand(b, s, 2) * size - 6   # some boxes start outside the map
    boxes = np.concatenate([xy, xy + 1 + rng.rand(b, s, 2) * size * 0.8], -1).astype(np.float32)
    matched = rng.randint(0, m, (b, s))
    labels = rng.randint(0, c, (b, m))
    pos = rng.rand(b, s) < 0.6
    logits = (rng.randn(b, s, 28, 28, c) * 3).astype(np.float32)
    return masks, boxes, matched, labels, pos, logits


def test_project_masks_on_boxes_matches_jax():
    masks, boxes, matched, *_ = mask_inputs(1)
    out = MR.project_masks_on_boxes(torch.from_numpy(masks), torch.from_numpy(boxes),
                                    torch.from_numpy(matched), 28)
    for i in range(masks.shape[0]):
        ref = JMR.project_masks_on_boxes(jnp.asarray(masks[i]), jnp.asarray(boxes[i]),
                                         jnp.asarray(matched[i]), 28)
        # the RoIAlign tests' tolerance: a sample position an ulp apart on a
        # 0/1 mask edge moves the target by that ulp
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    assert out.shape == (2, 12, 28, 28) and 0 < out.mean() < 1


@pytest.mark.parametrize("seed", [2, 3])
def test_maskrcnn_loss_and_gradient_match_jax(seed):
    masks, boxes, matched, labels, pos, logits = mask_inputs(seed)
    args = [jnp.asarray(a) for a in (boxes, masks, labels, matched, pos)]
    ref, grad = jax.value_and_grad(lambda lg: JMR.maskrcnn_loss(lg, *args))(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    out = MR.maskrcnn_loss(t, *[torch.from_numpy(a) for a in (boxes, masks, labels, matched,
                                                               pos)])
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-4)
    out.backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-9)
    # no positive: zero loss, as JAX's max(count, 1)
    none = MR.maskrcnn_loss(t, *[torch.from_numpy(a) for a in (boxes, masks, labels, matched,
                                                                np.zeros_like(pos))])
    assert none.item() == float(JMR.maskrcnn_loss(jnp.asarray(logits), *args[:4],
                                                  jnp.zeros_like(args[4]))) == 0.0


def test_maskrcnn_inference_matches_jax():
    *_, logits = mask_inputs(4)
    labels = np.array([[0, 3, -1, 2] * 3, [1, 1, 2, -1] * 3])  # -1: not valid
    ref = JMR.maskrcnn_inference(jnp.asarray(logits), jnp.asarray(labels))
    out = MR.maskrcnn_inference(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def paste_cases():
    rng = np.random.RandomState(7)
    d = 24
    blob = rng.randn(d, 28, 28)
    masks = (1.0 / (1.0 + np.exp(-8.0 * blob))).astype(np.float32)
    x0, y0 = rng.rand(d) * 40 - 6, rng.rand(d) * 46 - 6
    boxes = np.stack([x0, y0, x0 + rng.rand(d) * 28 + 0.4, y0 + rng.rand(d) * 30 + 0.4], 1)
    # tests/test_mask_paste_semantics.py's int64 truncation cases: integer
    # corners, a degenerate box (w = h = 1), negative corners truncated to 0
    boxes[:3] = [[4.0, 4.0, 14.0, 14.0], [10.2, 10.7, 10.4, 10.9], [-5.5, -3.2, 6.7, 9.9]]
    masks[:3] = 1.0
    return masks, boxes.astype(np.float32)


def test_paste_masks_in_image_matches_jax():
    masks, boxes = paste_cases()
    ref = JMR.paste_masks_in_image(jnp.asarray(masks), jnp.asarray(boxes), (60, 52))
    out = MR.paste_masks_in_image(torch.from_numpy(masks), torch.from_numpy(boxes), (60, 52))
    assert out.shape == (24, 60, 52)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    # the degenerate box pastes one pixel, the truncated one starts at 0
    assert (out[1] > 0).sum() == 1 and out[2, 0, 0] > 0


# -- the tiny model, eval and training --------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The tiny R(1,1,1,1)-FPN Mask R-CNN at 64 px, batch 2 (the second
    image has one GT), random frozen statistics, class scores scaled: the
    JAX variables, eval outputs, training losses and gradients with the
    keys its samplers took, and the port model holding the same weights."""
    cfg = JMR.MaskRCNNConfig(num_classes=5, rpn=TINY_RPN, roi=TINY_ROI,
                             resnet_layers=(1, 1, 1, 1))
    model = JMR.MaskRCNN(cfg)
    rng = np.random.RandomState(3)
    x = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    gt = np.array([[[4.0, 4.0, 24.0, 24.0], [30.0, 30.0, 50.0, 44.0], [0, 0, 0, 0]]] * 2,
                  np.float32)
    labels = np.array([[1, 3, 0], [2, 0, 0]])
    valid = np.array([[True, True, False], [True, False, False]])
    masks = np.zeros((2, 3, IMG, IMG), np.float32)
    masks[:, 0, 6:22, 5:20] = 1.0
    masks[:, 1, 32:44, 30:50] = 1.0
    masks[:, :2] *= rng.rand(2, 2, IMG, IMG) < 0.9  # holes
    args = tuple(jnp.asarray(a) for a in (x, gt, labels, valid, masks))
    v = jax.jit(lambda k: model.init({"params": k, "sampler": k}, *args, train=True))(
        jax.random.key(0))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["frozen"] = randomized_frozen(v["frozen"], 1)
    cls = v["params"]["box_predictor"]["cls_score"]
    cls["kernel"] = cls["kernel"] * 40.0
    total, losses, grads, keys, ref_eval = jax_train_with_keys(model, v, args,
                                                               jax.random.key(2), args[0])
    port = MR.MaskRCNN(port_mask_config(cfg))
    port.load_state_dict(flax_maskrcnn_to_torch(v["params"], v["frozen"]))
    return dict(cfg=cfg, port=port, x=x, gt=gt, labels=labels, valid=valid, masks=masks,
                total=total, losses=losses, grads=grads, ref_eval=ref_eval,
                draws=sampler_draws(keys, 2, IMG, TINY_RPN.post_nms_top_n_train, 3))


def test_tiny_maskrcnn_eval_matches_jax(tiny):
    with torch.no_grad():
        out = tiny["port"].eval()(torch.from_numpy(tiny["x"]))
    ref = tiny["ref_eval"]
    _assert_detections_equal(out[:4], ref[:4])
    assert out[4].shape == (2, 4, 28, 28) and out[3].sum() > 0
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]), rtol=1e-4, atol=1e-5)


def port_train(t):
    return t["port"].train()(*[torch.from_numpy(t[k]) for k in ("x", "gt", "labels", "valid",
                                                                 "masks")],
                             train=True, uniforms=t["draws"])


def test_tiny_maskrcnn_train_losses_and_gradients_match_jax(tiny):
    port = tiny["port"]
    port.zero_grad()
    out = port_train(tiny)
    assert sorted(out) == sorted(tiny["losses"])
    for k, ref in tiny["losses"].items():
        np.testing.assert_allclose(out[k].item(), ref, rtol=1e-4, err_msg=k)
        assert ref > 0, k
    sum(out.values()).backward()
    ref = flax_maskrcnn_to_torch(tiny["grads"], {})
    named = dict(port.named_parameters())
    assert set(ref) == set(named)
    for k, g in ref.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    # the mask loss reached the backbone through the 14x14 pooler's backward
    assert named["mask_head.mask_fcn1.weight"].grad.abs().sum() > 0
    assert named["backbone.resnet.layer1_block0.conv1.weight"].grad.abs().sum() > 0


def test_maskrcnn_training_needs_masks_and_training_mode(tiny):
    args = [torch.from_numpy(tiny[k]) for k in ("x", "gt", "labels", "valid")]
    with pytest.raises(ValueError, match="ground truth"):
        tiny["port"].train()(*args, train=True, uniforms=tiny["draws"])
    with pytest.raises(ValueError, match="training mode"):
        tiny["port"].eval()(*args, torch.from_numpy(tiny["masks"]), train=True,
                            uniforms=tiny["draws"])


def test_trained_synthetic_maskrcnn_matches_jax():
    """R50-FPN Mask R-CNN trained on the synthetic family (5 classes,
    96 px, through detection_main's adapter: 100 detections): the port's
    detections, masks and pasted masks equal JAX's on a rendered image of
    that family."""
    from flax import serialization

    from object_detectors_tpu.data import synthetic as SYN
    from object_detectors_tpu.kernels.preprocess import preprocess_images

    cfg = JMR.MaskRCNNConfig(num_classes=5, roi=JRH.RoIHeadsConfig(num_classes=5))
    model = JMR.MaskRCNN(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                               train=False))
    frozen = jax.tree_util.tree_map_with_path(
        lambda path, s: (np.ones if path[-1].key in ("weight", "running_var")
                         else np.zeros)(s.shape, np.float32), shapes["frozen"])
    art = ROOT / "artifacts" / "synthetic_maskrcnn.msgpack"
    params = serialization.msgpack_restore(art.read_bytes())["params"]
    gt, loader = SYN.renderable_dataset(np.random.RandomState(5), num_images=1, img_size=96,
                                        num_classes=4)
    u8 = np.stack([loader(info) for info in gt["images"]]).astype(np.uint8)
    x = np.array(preprocess_images(jnp.asarray(u8), jnp.float32))
    ref = jax.jit(lambda v, im: model.apply(v, im, train=False))(
        {"params": params, "frozen": frozen}, jnp.asarray(x))
    port = MR.MaskRCNN(port_mask_config(cfg))
    port.load_state_dict(flax_maskrcnn_to_torch(params, frozen))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    _assert_detections_equal(out[:4], ref[:4])
    assert out[3].sum() > 0  # the trained detector fires on its own family
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]), rtol=1e-4, atol=1e-4)
    n = int(out[3][0].sum())
    pasted = MR.paste_masks_in_image(out[4][0, :n], out[0][0, :n], (96, 96))
    pasted_ref = JMR.paste_masks_in_image(ref[4][0, :n], ref[0][0, :n], (96, 96))
    np.testing.assert_allclose(pasted.numpy(), np.asarray(pasted_ref), rtol=1e-4, atol=1e-4)
