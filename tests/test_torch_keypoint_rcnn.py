"""The port's Keypoint R-CNN (object_detectors_tpu_torch/models/
keypoint_rcnn.py) against the JAX KeypointRCNN in float32 on the CPU, on
the same numpy-seeded inputs and weights moved by utils/weights.py: the
heatmap targets (points on cell edges too), the loss and its gradients,
both decodes, the heads, the tiny model in eval and training (the
samplers' draws replayed from the jitted JAX step's keys), and the trained
``artifacts/synthetic_kprcnn.msgpack`` at 96 px.

Target cells, valid flags, kept sets and labels must be identical; losses
within rtol 1e-4, gradients as tests/test_torch_mask_rcnn.py; keypoint
coordinates within atol 1e-3 (tests/test_keypoints.py) and scores within
rtol 1e-4."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.models import keypoint_rcnn as JKR
from object_detectors_tpu.models import roi_heads as JRH
from object_detectors_tpu_torch.models import keypoint_rcnn as KR
from object_detectors_tpu_torch.utils.weights import flax_kprcnn_to_torch
from test_torch_frcnn import _assert_detections_equal, port_roi_config, port_rpn_config
from test_torch_frcnn import randomized_frozen
from test_torch_frcnn_train import GRAD_ATOL, GRAD_RTOL
from test_torch_mask_rcnn import IMG, TINY_RPN, jax_train_with_keys, sampler_draws

ROOT = Path(__file__).resolve().parent.parent
TINY_ROI = JRH.RoIHeadsConfig(num_classes=2, batch_size_per_image=8, detections_per_img=4,
                              pooler_method="canvas")
KP_ATOL = 1e-3


def port_kp_config(cfg) -> KR.KeypointRCNNConfig:
    return KR.KeypointRCNNConfig(
        num_classes=cfg.num_classes, num_keypoints=cfg.num_keypoints,
        rpn=port_rpn_config(cfg.rpn), roi=port_roi_config(cfg.roi),
        resnet_layers=cfg.resnet_layers, keypoint_pool_size=cfg.keypoint_pool_size,
        kp_head_layers=cfg.kp_head_layers, kp_head_features=cfg.kp_head_features)


def keypoint_inputs(seed, s=10, k=5):
    rng = np.random.RandomState(seed)
    xy = rng.rand(s, 2) * 50
    boxes = np.concatenate([xy, xy + 3 + rng.rand(s, 2) * 60], -1).astype(np.float32)
    boxes[0] = [10.0, 20.0, 66.0, 76.0]  # 56 px: one pixel a cell
    boxes[1] = [0.0, 0.0, 28.0, 112.0]   # half and double cells
    kps = np.concatenate([boxes[:, None, :2] + rng.rand(s, k, 2) * (boxes[:, None, 2:]
                                                                  - boxes[:, None, :2]) * 1.2,
                          (rng.rand(s, k, 1) < 0.8) * 2.0], -1).astype(np.float32)
    # on cell edges, on the far edges (the last cell), outside
    kps[0, :, :2] = [[10.0, 20.0], [66.0, 76.0], [38.0, 48.0], [9.999, 30.0], [67.5, 30.0]]
    kps[1, :, :2] = [[0.5, 2.0], [28.0, 112.0], [14.0, 56.0], [27.9999, 0.0], [1.5, 111.99]]
    kps[:2, :, 2] = 2.0
    return boxes, kps


def test_keypoints_to_heatmap_matches_jax_on_cell_edges():
    boxes, kps = keypoint_inputs(0)
    ref_cell, ref_valid = JKR.keypoints_to_heatmap(jnp.asarray(kps), jnp.asarray(boxes), 56)
    cell, valid = KR.keypoints_to_heatmap(torch.from_numpy(kps), torch.from_numpy(boxes), 56)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(cell.numpy(), np.asarray(ref_cell))
    assert cell[0, 1] == 56 * 56 - 1 and not valid[0, 3] and not valid[0, 4]
    assert valid.any() and not valid.all()


def test_keypointrcnn_loss_and_gradient_match_jax():
    rng = np.random.RandomState(1)
    b, s, m, k = 2, 10, 3, 5
    boxes = np.stack([keypoint_inputs(i)[0] for i in (2, 3)])
    kps = np.stack([keypoint_inputs(i, s=m)[1] for i in (4, 5)])
    matched = rng.randint(0, m, (b, s))
    pos = rng.rand(b, s) < 0.7
    logits = (rng.randn(b, s, 56, 56, k) * 2).astype(np.float32)
    args = [jnp.asarray(a) for a in (boxes, kps, matched, pos)]
    ref, grad = jax.value_and_grad(lambda lg: JKR.keypointrcnn_loss(lg, *args))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    out = KR.keypointrcnn_loss(t, *[torch.from_numpy(a) for a in (boxes, kps, matched, pos)])
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-4)
    out.backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad), rtol=1e-4, atol=1e-9)
    # no valid keypoint: zero loss
    none = KR.keypointrcnn_loss(t, *[torch.from_numpy(a) for a in (boxes, kps, matched,
                                                                    np.zeros_like(pos))])
    assert none.item() == 0.0


@pytest.mark.parametrize("upsample", [1, 4])
def test_heatmaps_to_keypoints_matches_jax(upsample):
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 3, 14, 14, 4).astype(np.float32)
    xy = rng.rand(2, 3, 2) * 60
    boxes = np.concatenate([xy, xy + 2 + rng.rand(2, 3, 2) * 80], -1).astype(np.float32)
    ref = JKR.heatmaps_to_keypoints(jnp.asarray(logits), jnp.asarray(boxes), upsample)
    out = KR.heatmaps_to_keypoints(torch.from_numpy(logits), torch.from_numpy(boxes), upsample)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=KP_ATOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-7)


def test_jax_bicubic_matrix_is_jax_image_resize():
    x = np.random.RandomState(7).randn(14, 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (56, 3), "bicubic")
    np.testing.assert_allclose(KR._jax_bicubic_matrix(14, 56) @ x, np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_heatmaps_to_keypoints_exact_matches_jax(monkeypatch):
    """tests/test_keypoints.py's boxes (small, extreme aspect, large),
    sub-pixel ones, one past the 512 cap, a zero box; in chunks of 4."""
    monkeypatch.setattr(KR, "EXACT_CHUNK", 4)
    rng = np.random.RandomState(8)
    boxes = np.array([[[0.0, 0.0, 33.4, 41.9], [5.0, 5.0, 6.2, 505.0],
                       [100.0, 100.0, 499.0, 480.0], [3.3, 4.4, 3.9, 5.1],
                       [0.0, 0.0, 600.5, 20.0], [0.0, 0.0, 0.0, 0.0]]], np.float32)
    logits = rng.randn(1, 6, 8, 8, 3).astype(np.float32)
    logits[0, 3] = 0.0  # a flat heatmap: argmax ties go to the first cell
    ref = JKR.heatmaps_to_keypoints_exact(jnp.asarray(logits), jnp.asarray(boxes))
    out = KR.heatmaps_to_keypoints_exact(torch.from_numpy(logits), torch.from_numpy(boxes))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=KP_ATOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-5)


def test_keypoint_heads_and_predictor_match_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 14, 14, 8).astype(np.float32)
    head = JKR.KeypointRCNNHeads(layers=2, features=16)
    pred = JKR.KeypointRCNNPredictor(num_keypoints=5)
    vh = head.init(jax.random.key(0), jnp.asarray(x))
    vp = pred.init(jax.random.key(1), head.apply(vh, jnp.asarray(x)))
    params = {"kp_head": dict(vh["params"]), "kp_predictor": dict(vp["params"])}
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.randn(*a.shape).astype(
        np.float32) * 0.1, params)
    ref = pred.apply({"params": params["kp_predictor"]},
                     head.apply({"params": params["kp_head"]}, jnp.asarray(x)))
    port = torch.nn.ModuleDict({"kp_head": KR.KeypointRCNNHeads(8, 2, 16),
                                "kp_predictor": KR.KeypointRCNNPredictor(16, 5)})
    port.load_state_dict(flax_kprcnn_to_torch(params, {}))
    with torch.no_grad():
        out = port["kp_predictor"](port["kp_head"](torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert out.shape == (2, 5, 56, 56)
    # the 2x bilinear upscale is jax.image.resize's within 5e-7, not bitwise
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    """A tiny R(1,1,1,1)-FPN Keypoint R-CNN (2 classes, 5 keypoints, a
    2 x 16 head) at 64 px, batch 2, random frozen statistics, class scores
    scaled; as tests/test_torch_mask_rcnn.py's fixture."""
    cfg = JKR.KeypointRCNNConfig(num_classes=2, num_keypoints=5, rpn=TINY_RPN, roi=TINY_ROI,
                                 resnet_layers=(1, 1, 1, 1), kp_head_layers=2,
                                 kp_head_features=16)
    model = JKR.KeypointRCNN(cfg)
    rng = np.random.RandomState(4)
    x = rng.randn(2, IMG, IMG, 3).astype(np.float32)
    gt = np.array([[[4.0, 4.0, 30.0, 36.0], [30.0, 24.0, 58.0, 50.0]]] * 2, np.float32)
    labels = np.ones((2, 2), np.int64)
    valid = np.array([[True, True], [True, False]])
    kps = np.concatenate([gt[:, :, None, :2] + rng.rand(2, 2, 5, 2) * 26,
                          (rng.rand(2, 2, 5, 1) < 0.8) * 2.0], -1).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (x, gt, labels, valid, kps))
    v = jax.jit(lambda k: model.init({"params": k, "sampler": k}, *args, train=True))(
        jax.random.key(0))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["frozen"] = randomized_frozen(v["frozen"], 2)
    cls = v["params"]["box_predictor"]["cls_score"]
    cls["kernel"] = cls["kernel"] * 40.0
    total, losses, grads, keys, ref_eval = jax_train_with_keys(model, v, args,
                                                               jax.random.key(3), args[0])
    port = KR.KeypointRCNN(port_kp_config(cfg))
    port.load_state_dict(flax_kprcnn_to_torch(v["params"], v["frozen"]))
    return dict(port=port, x=x, gt=gt, labels=labels, valid=valid, kps=kps, losses=losses,
                grads=grads, ref_eval=ref_eval,
                draws=sampler_draws(keys, 2, IMG, TINY_RPN.post_nms_top_n_train, 2))


def test_tiny_kprcnn_eval_matches_jax(tiny):
    with torch.no_grad():
        out = tiny["port"].eval()(torch.from_numpy(tiny["x"]))
    ref = tiny["ref_eval"]
    _assert_detections_equal(out[:4], ref[:4])
    assert out[4].shape == (2, 4, 5, 3) and out[3].sum() > 0
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]), rtol=0, atol=KP_ATOL)
    np.testing.assert_allclose(out[5].numpy(), np.asarray(ref[5]), rtol=1e-4, atol=1e-5)


def test_tiny_kprcnn_train_losses_and_gradients_match_jax(tiny):
    port = tiny["port"]
    port.zero_grad()
    out = port.train()(*[torch.from_numpy(tiny[k]) for k in ("x", "gt", "labels", "valid",
                                                              "kps")],
                       train=True, uniforms=tiny["draws"])
    assert sorted(out) == sorted(tiny["losses"])
    for k, ref in tiny["losses"].items():
        np.testing.assert_allclose(out[k].item(), ref, rtol=1e-4, err_msg=k)
    assert tiny["losses"]["loss_keypoint"] > 0
    sum(out.values()).backward()
    ref = flax_kprcnn_to_torch(tiny["grads"], {})
    named = dict(port.named_parameters())
    assert set(ref) == set(named)
    for k, g in ref.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    assert named["kp_predictor.kps_score_lowres.weight"].grad.abs().sum() > 0


def test_trained_synthetic_kprcnn_matches_jax():
    """R50-FPN Keypoint R-CNN (2 classes, 17 keypoints, 8 x 512 head)
    trained on the synthetic person-only family at 96 px: the port's
    detections and keypoints equal JAX's on a rendered image of that family.
    20 detection slots (the adapter it was trained through keeps 100): the
    8 x 512 head on every slot is most of this test's CPU time."""
    from flax import serialization

    from object_detectors_tpu.data import synthetic as SYN
    from object_detectors_tpu.kernels.preprocess import preprocess_images

    cfg = JKR.KeypointRCNNConfig(roi=JRH.RoIHeadsConfig(num_classes=2, detections_per_img=20))
    model = JKR.KeypointRCNN(cfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                               train=False))
    frozen = jax.tree_util.tree_map_with_path(
        lambda path, s: (np.ones if path[-1].key in ("weight", "running_var")
                         else np.zeros)(s.shape, np.float32), shapes["frozen"])
    art = ROOT / "artifacts" / "synthetic_kprcnn.msgpack"
    params = serialization.msgpack_restore(art.read_bytes())["params"]
    gt = SYN.make_coco_dicts(np.random.RandomState(5), 1, 96, 1, with_keypoints=True)
    u8 = SYN.render_image(gt, gt["images"][0]["id"])[None]
    x = np.array(preprocess_images(jnp.asarray(u8), jnp.float32))
    ref = jax.jit(lambda v, im: model.apply(v, im, train=False))(
        {"params": params, "frozen": frozen}, jnp.asarray(x))
    port = KR.KeypointRCNN(port_kp_config(cfg))
    port.load_state_dict(flax_kprcnn_to_torch(params, frozen))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    _assert_detections_equal(out[:4], ref[:4])
    assert out[3].sum() > 0  # the trained detector fires on its own family
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]), rtol=0, atol=KP_ATOL)
    np.testing.assert_allclose(out[5].numpy(), np.asarray(ref[5]), rtol=1e-4, atol=1e-4)
