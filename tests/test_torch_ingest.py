"""The port's device-ingest resizes (object_detectors_tpu_torch/kernels/
preprocess.py: cubic_kernel, bicubic_rows, bilinear_rows,
resize_normalize_from_canvas, rcnn_resize_normalize_from_canvas,
resize_normalize_images) and the two ingest train steps
(train/trainer.py) against the JAX package's, on the CPU.

Tolerances: the sampling matrices within 1e-6 absolute (the same f32
formulas); the resized, normalized images within 1e-5 rtol/atol in f32 (the
same matrices; XLA and PyTorch sum the products in other orders, 4e-6 seen),
tighter than tests/test_kernels.py's 1e-4 against torch's bicubic; the
target sizes and scales exact. The YOLO ingest step holds to
tests/test_torch_train.py's one-step f32 tolerances (loss, sub-losses and
stats rtol 1e-4, grad_norm 1e-3). The Faster R-CNN ingest step is held
against the port's own ``frcnn_train_step`` on the images JAX's resize
gives, with the same sampler draws: the losses within rtol 1e-4, each
parameter's update within tests/test_torch_frcnn_train.py's gradient
tolerance."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.kernels import preprocess as JP
from object_detectors_tpu.models import yolo_criterion as JYC
from object_detectors_tpu.models.yolo import YoloHead as FlaxYoloHead
from object_detectors_tpu.train import optim as JO
from object_detectors_tpu.train import trainer as JT
from object_detectors_tpu_torch.kernels import preprocess as P
from object_detectors_tpu_torch.models import faster_rcnn as F
from object_detectors_tpu_torch.models import roi_heads as RH
from object_detectors_tpu_torch.models import rpn as RPN
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.models.yolo import YoloHead
from object_detectors_tpu_torch.train import optim as O
from object_detectors_tpu_torch.train import trainer as T
from object_detectors_tpu_torch.utils.weights import flax_yolo_to_torch
from test_torch_yolo import randomize_bn

RTOL = ATOL = 1e-5
CANVAS = 96
# ragged true sizes inside the 96-px canvas: full, wide, tall, small
SIZES = np.array([[96, 96], [60, 80], [90, 41], [33, 17]], np.int32)


def canvas_batch(seed=0, sizes=SIZES):
    """uint8 canvases with each image's pixels in its top-left (h, w) and
    noise beyond it, which the resizes must not read."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (len(sizes), CANVAS, CANVAS, 3)).astype(np.uint8), sizes


def test_cubic_kernel_is_jax_s():
    t = np.linspace(-3, 3, 241, dtype=np.float32)
    np.testing.assert_allclose(P.cubic_kernel(torch.from_numpy(t)).numpy(),
                               np.asarray(JP.cubic_kernel(jnp.asarray(t))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out,size", [(96, 64, 96), (96, 64, 41), (96, 160, 80),
                                             (32, 32, 32), (96, 7, 17)])
def test_sampling_rows_are_jax_s(n_in, n_out, size):
    h = np.float32(size)
    ours = P.bicubic_rows(torch.tensor([h / n_out]), torch.tensor([h]), n_in, n_out)[0]
    ref = JP.bicubic_rows(jnp.float32(h) / n_out, jnp.float32(h), n_in, n_out)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    nn = np.float32(max(1, round(size * n_out / n_in)))
    ours = P.bilinear_rows(torch.tensor([h / nn]), torch.tensor([h]), n_in, n_out,
                           torch.tensor([nn]))[0]
    ref = JP.bilinear_rows(jnp.float32(h) / nn, jnp.float32(h), n_in, n_out, jnp.float32(nn))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    assert not ours[int(nn):].any()


@pytest.mark.parametrize("out_dim", [64, 128])
def test_resize_normalize_from_canvas_is_jax_s(out_dim):
    canvas, sizes = canvas_batch(1)
    ours = P.resize_normalize_from_canvas(torch.from_numpy(canvas), torch.from_numpy(sizes),
                                          out_dim, torch.float32)
    ref = JP.resize_normalize_from_canvas(jnp.asarray(canvas), jnp.asarray(sizes), out_dim,
                                          jnp.float32)
    assert ours.shape == (4, out_dim, out_dim, 3) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # bf16 is the f32 result rounded once
    bf16 = P.resize_normalize_from_canvas(torch.from_numpy(canvas), torch.from_numpy(sizes),
                                          out_dim)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, ours.to(torch.bfloat16))


@pytest.mark.parametrize("min_sizes", [None, (50.0, 70.0, 90.0, 40.0)])
@pytest.mark.parametrize("out_hw,min_size,max_size", [((96, 96), 64, 96),
                                                      ((64, 96), 80, 133)])
def test_rcnn_resize_normalize_from_canvas_is_jax_s(out_hw, min_size, max_size, min_sizes):
    canvas, sizes = canvas_batch(2)
    ms = None if min_sizes is None else np.array(min_sizes, np.float32)
    ours = P.rcnn_resize_normalize_from_canvas(
        torch.from_numpy(canvas), torch.from_numpy(sizes), out_hw, min_size, max_size,
        min_sizes=None if ms is None else torch.from_numpy(ms))
    ref = JP.rcnn_resize_normalize_from_canvas(
        jnp.asarray(canvas), jnp.asarray(sizes), out_hw, min_size, max_size,
        min_sizes=None if ms is None else jnp.asarray(ms))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert ours[1].dtype == torch.int32
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    # the pad beyond each image's target size is zero
    for img, (nh, nw) in zip(ours[0], ours[1].tolist()):
        assert not img[nh:].any() and not img[:, nw:].any()


@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("out_hw", [(40, 56), (128, 100), (96, 96), (37, 150)])
def test_resize_normalize_images_is_jax_s(out_hw, antialias):
    """jax.image.resize's bilinear and torch's agree, antialiased downscales
    included (the same triangle over half-pixel centers, normalized)."""
    canvas, _ = canvas_batch(3)
    ours = P.resize_normalize_images(torch.from_numpy(canvas), out_hw, torch.float32,
                                     antialias)
    ref = JP.resize_normalize_images(jnp.asarray(canvas), out_hw, jnp.float32, antialias)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_yolo_train_step_ingest_matches_jax():
    """Tiny Darknet (1, 1, 1, 1, 1), 4 classes, 64 px from the 96-px canvas,
    one SGD step in f32, JAX and port from the same weights."""
    num_classes, img = 4, 64
    canvas, sizes = canvas_batch(4, SIZES[:2])
    cfg = JYC.YoloLossConfig(num_classes=num_classes, img_size=img)
    opt = O.OptimizerConfig("sgd", 1e-3, 5e-4, 0.9)
    sch = O.SchedulerConfig()
    flax_model = FlaxYoloHead(num_classes=num_classes, backbone_layers=(1, 1, 1, 1, 1))
    v = jax.jit(lambda k: flax_model.init(k, jnp.zeros((1, img, img, 3)), train=False))(
        jax.random.key(0))
    v = randomize_bn(v, 7)
    jstate = JT.TrainState.create(
        flax_model.apply, jax.tree_util.tree_map(jnp.asarray, v["params"]),
        jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
        JO.make_optimizer(JO.OptimizerConfig(**dataclasses.asdict(opt)),
                          JO.SchedulerConfig(**dataclasses.asdict(sch))))
    model = YoloHead(num_classes, 3, (1, 1, 1, 1, 1))
    model.load_state_dict(flax_yolo_to_torch(v["params"], v["batch_stats"]))
    state = T.create_yolo_train_state(model, O.make_optimizer(opt, sch))

    rng = np.random.RandomState(5)
    boxes = np.concatenate([rng.rand(2, 6, 2) * 0.6 + 0.2, rng.rand(2, 6, 2) * 0.4 + 0.05],
                           -1).astype(np.float32)
    labels = rng.randint(0, num_classes, (2, 6))
    valid = rng.rand(2, 6) < 0.7
    _, jm = JT.yolo_train_step_ingest(jstate, jnp.asarray(canvas), jnp.asarray(sizes),
                                      jnp.asarray(boxes), jnp.asarray(labels),
                                      jnp.asarray(valid), cfg, num_classes)
    state, m = T.yolo_train_step_ingest(
        state, torch.from_numpy(canvas), torch.from_numpy(sizes), torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(valid),
        YC.YoloLossConfig(**dataclasses.asdict(cfg)), num_classes)
    for key in ("loss", "sub_losses", "stats"):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jm["grad_norm"]), rtol=1e-3)
    assert state.step == 1


def test_frcnn_train_step_ingest_is_the_step_on_jax_s_resize():
    """A tiny Faster R-CNN (ResNet (1, 1, 1, 1), 5 classes) at a 64² canvas
    of out_hw from native images of 96² and smaller, per-image drawn min
    sizes: the ingest step equals frcnn_train_step on the images JAX's
    rcnn_resize_normalize_from_canvas gives, with the same draws."""
    cfg = F.FasterRCNNConfig(
        num_classes=5, rpn=RPN.RPNConfig(pre_nms_top_n_train=32, post_nms_top_n_train=16,
                                         batch_size_per_image=16),
        roi=RH.RoIHeadsConfig(num_classes=5, batch_size_per_image=8),
        resnet_layers=(1, 1, 1, 1))
    canvas, sizes = canvas_batch(6, SIZES[:2])
    min_sizes = np.array([56.0, 48.0], np.float32)
    out_hw = (64, 64)
    gt = torch.tensor([[[4.0, 4.0, 24.0, 24.0], [30.0, 30.0, 50.0, 44.0]],
                       [[10.0, 8.0, 40.0, 30.0], [0.0, 0.0, 0.0, 0.0]]])
    labels, valid = torch.tensor([[1, 3], [2, 0]]), torch.tensor([[True, True], [True, False]])
    a_total = 3 * (16 ** 2 + 8 ** 2 + 4 ** 2 + 2 ** 2 + 1)
    g = torch.Generator().manual_seed(2)
    draws = {"rpn": (torch.rand(2, a_total, generator=g), torch.rand(2, a_total, generator=g)),
             "roi": (torch.rand(2, 18, generator=g), torch.rand(2, 18, generator=g))}
    lr = 0.0025
    tx = O.make_optimizer(O.OptimizerConfig("sgd", lr, 1e-4, 0.9), O.SchedulerConfig())
    model = F.init_frcnn_(F.FasterRCNN(cfg), seed=3)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    states = [T.create_frcnn_train_state(copy.deepcopy(model), tx) for _ in range(2)]

    _, total, losses = T.frcnn_train_step_ingest(
        states[0], torch.from_numpy(canvas), torch.from_numpy(sizes), gt, labels, valid,
        out_hw, min_sizes=torch.from_numpy(min_sizes), max_size=133, uniforms=draws)
    images, _, _ = JP.rcnn_resize_normalize_from_canvas(
        jnp.asarray(canvas), jnp.asarray(sizes), out_hw, max_size=133,
        min_sizes=jnp.asarray(min_sizes))
    _, ref_total, ref_losses = T.frcnn_train_step(states[1], torch.from_numpy(
        np.array(images)), gt, labels, valid, uniforms=draws)
    np.testing.assert_allclose(total.item(), ref_total.item(), rtol=1e-4)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(losses[k].item(), v.item(), rtol=1e-4, err_msg=k)
    ref = dict(states[1].model.named_parameters())
    moved = 0
    for k, p in states[0].model.named_parameters():
        upd, upd_ref = (p.detach() - before[k]), (ref[k].detach() - before[k])
        np.testing.assert_allclose(upd.numpy(), upd_ref.numpy(), rtol=1e-3,
                                   atol=lr * 1e-5 + 2.5e-7, err_msg=k)
        moved += bool(upd_ref.abs().max() > 0)
    assert moved > len(before) // 2
