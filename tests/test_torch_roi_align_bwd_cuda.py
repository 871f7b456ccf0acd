"""The RoIAlign backward kernel (object_detectors_tpu_torch/csrc/roi_align.cu,
``roi_align_backward``) against its plain version on the GPU, and one train
step of each family on the GPU against the same step on the CPU. Imports no
JAX, so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_roi_align_bwd_cuda.py

Tolerances: the kernel adds the same products as the plain version (both
without FMA contraction) with f32 atomics, whose order changes from run to
run, so in f32 1e-5 absolute and 1e-4 relative; in bf16 both round that f32
sum once, so within one bf16 ulp of max(|plain|, 1). The train steps and
their tolerances are those of object_detectors_tpu_torch/train/tiny_steps.py,
which chip_smoke.py runs too. Every kernel case also reads the route the
kernel took for each RoI (its level, and whether it staged the RoI's
cotangent and summed each footprint pixel before reducing, or reduced
every sample's corners directly) and holds it against ``assign_fpn_levels``
and the rule of kernels/roi_align.py:backward_routes.
"""

import numpy as np
import pytest
import torch

from object_detectors_tpu_torch.kernels import roi_align as K
from object_detectors_tpu_torch.kernels import roi_align_bwd as KB
from object_detectors_tpu_torch.ops.roi_align import assign_fpn_levels, pool_multiscale
from object_detectors_tpu_torch.train import tiny_steps as TS


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _case(seed, b, n, size, c, dtype):
    rng = np.random.RandomState(seed)
    shapes = [(b, c, size // s, size // s) for s in (4, 8, 16, 32)]
    xy = rng.rand(b, n, 2) * (size - 30)
    wh = rng.rand(b, n, 2) * ((rng.rand(b, n, 1) > 0.5) * size / 2 + 8)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    extreme = [[-50, -40, 30, 20], [0, 0, size, 6], [size - 2, size - 2, size + 90, size + 60],
               [-300, -300, size, size]]
    boxes[0, :4] = extreme[:n]
    grad = torch.from_numpy(rng.randn(b, n, 7, 7, c).astype(np.float32)).cuda().to(dtype)
    return shapes, torch.from_numpy(boxes).cuda(), grad


def assert_backward_agrees(got, ref, dtype):
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert g.is_contiguous(memory_format=torch.channels_last)
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5)
        else:
            ulp = (r.float().abs().clamp(min=1.0).log2().floor() - 7).exp2()
            assert bool(((g.float() - r.float()).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,size,c", [(2, 64, 800, 256), (2, 40, 256, 8), (1, 1, 256, 8),
                                        (1, 9, 128, 3), (2, 7, 96, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain(b, n, size, c, dtype):
    _needs_gpu()
    shapes, boxes, grad = _case(b * n + c, b, n, size, c, dtype)
    before = KB.launches
    got = KB.multiscale_roi_align_backward_cuda(grad, boxes, shapes, (size, size), dtype=dtype)
    assert KB.launches == before + 1
    ref = KB.multiscale_roi_align_backward_reference(grad, boxes, shapes, (size, size),
                                                     dtype=dtype)
    torch.cuda.synchronize()
    assert_backward_agrees(got, ref, dtype)
    assert any(r.abs().amax() > 0 for r in ref)


def _boxes(rng, b, n, lo, hi, size):
    """n boxes an image, sides drawn in [lo, hi) pixels, corners anywhere
    that keeps them within [-hi / 2, size + hi / 2]."""
    wh = lo + rng.rand(b, n, 2) * (hi - lo)
    xy = rng.rand(b, n, 2) * (size + hi) - hi / 2 - wh / 2
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# name -> (levels, B, N, image side, C, output size, box sides lo..hi)
EDGE_CASES = {
    "all under 4 px": (4, 2, 96, 256, 256, (7, 7), (0.2, 4)),
    "largest 7x7 footprint, 28 x 28": (1, 2, 24, 256, 256, (7, 7), (112, 200)),
    "14x14, footprints to 56 x 56": (1, 2, 12, 256, 64, (14, 14), (60, 224)),
    "C = 6, scalar reductions": (4, 2, 40, 256, 6, (7, 7), (2, 300)),
    "half outside the map": (4, 2, 40, 256, 16, (7, 7), (20, 500)),
    "a one-pixel level": (4, 1, 24, 32, 8, (7, 7), (1, 900)),
}


def _checked_backward(shapes, boxes, grad, size, out, dtype, s=2):
    """The kernel with its route, held to the plain version and the rule."""
    route = torch.full(boxes.shape[:2], 255, dtype=torch.uint8, device="cuda")
    got = KB.multiscale_roi_align_backward_cuda(grad, boxes, shapes, (size, size), out, s,
                                                dtype=dtype, route=route)
    staged, foot = K.backward_routes(shapes, boxes, (size, size), out, s)
    torch.cuda.synchronize()
    assert torch.equal((route // 2).int(), assign_fpn_levels(boxes, len(shapes)))
    assert torch.equal((route % 2).bool(), staged)
    return got, foot, staged


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EDGE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_edge_cases(case, dtype):
    _needs_gpu()
    levels, b, n, size, c, out, (lo, hi) = EDGE_CASES[case]
    rng = np.random.RandomState(len(case))
    shapes = [(b, c, -(-size // s), -(-size // s)) for s in (4, 8, 16, 32)[:levels]]
    boxes = _boxes(rng, b, n, lo, hi, size)
    if out == (14, 14):
        boxes[0, 0] = [16, 16, 240, 240]  # bins of 4 pixels on P2: 56 x 56
    boxes = torch.from_numpy(boxes).cuda()
    grad = torch.from_numpy(rng.randn(b, n, *out, c).astype(np.float32)).cuda().to(dtype)
    got, foot, staged = _checked_backward(shapes, boxes, grad, size, out, dtype)
    ref = KB.multiscale_roi_align_backward_reference(grad, boxes, shapes, (size, size), out,
                                                     dtype=dtype)
    assert_backward_agrees(got, ref, dtype)
    if case.startswith("all under"):
        assert int(foot.max()) <= 16 and bool(staged.all())
    elif case.startswith("largest"):  # the 28 x 28 footprints go direct, smaller ones staged
        assert int(foot.max()) == 28 * 28 and bool(staged.any()) and not bool(staged.all())
    elif case.startswith("14x14"):  # the 56 x 56 footprint goes direct
        assert int(foot.max()) == 56 * 56 and not bool(staged.view(-1)[0])
    elif case.startswith("half"):
        assert float(((boxes < 0) | (boxes > size)).any(-1).float().mean()) >= 0.25
    elif case.startswith("a one-pixel"):
        assert shapes[-1][2:] == (1, 1)
        assert bool((assign_fpn_levels(boxes, levels) == levels - 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("out,s", [((14, 14), 4), ((7, 7), 8), ((7, 7), 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_at_larger_sampling_ratios(out, s, dtype):
    """Outputs and sampling ratios whose blocks hold many items: the kernel
    narrows its channel slice (to 20 of 64 channels at 7x7, s = 32) so
    that a block's items stay under 2^22, and still agrees."""
    _needs_gpu()
    rng = np.random.RandomState(s)
    shapes = [(2, 64, 256 // st, 256 // st) for st in (4, 8, 16, 32)]
    boxes = torch.from_numpy(_boxes(rng, 2, 12, 2, 300, 256)).cuda()
    grad = torch.from_numpy(rng.randn(2, 12, *out, 64).astype(np.float32)).cuda().to(dtype)
    got, _, _ = _checked_backward(shapes, boxes, grad, 256, out, dtype, s)
    ref = KB.multiscale_roi_align_backward_reference(grad, boxes, shapes, (256, 256), out, s,
                                                     dtype=dtype)
    assert_backward_agrees(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_with_no_rois(dtype):
    _needs_gpu()
    shapes = [(2, 8, 64 // s, 64 // s) for s in (4, 8, 16, 32)]
    boxes = torch.zeros(2, 0, 4, device="cuda")
    grad = torch.zeros(2, 0, 7, 7, 8, device="cuda", dtype=dtype)
    got, _, _ = _checked_backward(shapes, boxes, grad, 64, (7, 7), dtype)
    assert [tuple(g.shape) for g in got] == shapes
    assert all(g.dtype == dtype and not bool(g.any()) for g in got)


@pytest.mark.cuda
def test_pool_multiscale_under_autograd_launches_both_kernels():
    _needs_gpu()
    shapes, boxes, grad = _case(3, 2, 30, 256, 16, torch.float32)
    maps = [torch.randn(s[0], s[2], s[3], s[1], device="cuda").permute(0, 3, 1, 2)
            .requires_grad_() for s in shapes]
    fwd, bwd = K.launches, KB.launches
    out = pool_multiscale(maps, boxes, (256, 256))
    (out * grad).sum().backward()
    assert (K.launches, KB.launches) == (fwd + 1, bwd + 1)
    ref = KB.multiscale_roi_align_backward_reference(grad, boxes, shapes, (256, 256))
    assert_backward_agrees([m.grad for m in maps], ref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_yolo_train_step_on_the_gpu_matches_the_cpu(dtype):
    _needs_gpu()
    models, before, metrics = TS.yolo_step_on_both(dtype)
    for key in ("loss", "sub_losses", "stats"):
        torch.testing.assert_close(metrics["cuda"][key].cpu(), metrics["cpu"][key],
                                   rtol=TS.TRAIN_LOSS_RTOL, atol=1e-6)
    gap = TS.update_gap(models, before)
    if dtype == torch.float32:
        assert gap["norm_share"] <= TS.YOLO_F32_UPDATE_NORM, gap
    else:
        assert gap["worst_share"] <= TS.YOLO_F64_UPDATE_SHARE, gap
    bn = "backbone.stem.bn.running_var"
    torch.testing.assert_close(models["cuda"].state_dict()[bn].cpu(),
                               models["cpu"].state_dict()[bn], rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_frcnn_train_step_on_the_gpu_matches_the_cpu():
    _needs_gpu()
    models, before, losses, launches = TS.frcnn_step_on_both()
    assert launches == {"cpu": (0, 0, 0), "cuda": (1, 1, 1)}
    for k, v in losses["cpu"].items():
        torch.testing.assert_close(losses["cuda"][k].cpu(), v, rtol=TS.FRCNN_LOSS_RTOL,
                                   atol=1e-6)
    gap = TS.update_gap(models, before)
    assert gap["worst_share"] <= TS.FRCNN_UPDATE_SHARE, gap
