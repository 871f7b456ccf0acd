"""The RoIAlign kernel (object_detectors_tpu_torch/csrc/roi_align.cu)
against its plain PyTorch version on the GPU. Imports no JAX, so that it
runs on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_roi_align_cuda.py

The kernel stages a RoI's footprint in shared memory when it fits and
reads the corners directly otherwise; the cases below put RoIs of both
kinds in one launch and check each RoI's branch against the rule
``staged_rois`` states, and the level the kernel computed for it
against ``assign_fpn_levels``.

Tolerances: in f32 the kernel computes every sample position and weight as
the plain version does (both without FMA contraction) and sums in another
order, so 1e-5 absolute and 1e-4 relative. In bf16 the kernel rounds its
f32 result once, so it lies within one bf16 ulp of the f32 kernel on the same
maps, and within one ulp (2^-7 relative) plus 1e-5 of the plain version.
"""

import numpy as np
import pytest
import torch

from object_detectors_tpu_torch.kernels import roi_align as K
from object_detectors_tpu_torch.ops.roi_align import assign_fpn_levels


def _case(seed, b, n, size, c, dtype, extreme=False):
    rng = np.random.RandomState(seed)
    maps = [torch.from_numpy(rng.randn(b, size // s, size // s, c).astype(np.float32))
            .cuda().permute(0, 3, 1, 2).to(dtype) for s in (4, 8, 16, 32)]
    xy = rng.rand(b, n, 2) * (size - 30)
    wh = rng.rand(b, n, 2) * ((rng.rand(b, n, 1) > 0.5) * 200 + 8)
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if extreme:  # outside the image, extreme aspects, degenerate
        boxes[0, :6] = [[-50, -40, 30, 20], [0, 0, size, 6], [3, 0, 9, size],
                        [20, 20, 20, 20], [40, 40, 30, 30], [size - 2, size - 2, size + 90, size + 60]]
    return maps, torch.from_numpy(boxes).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,size,c,out,extreme", [
    (2, 40, 256, 8, (7, 7), True), (1, 1, 256, 8, (7, 7), False), (2, 12, 256, 8, (14, 14), True),
    (2, 64, 640, 256, (7, 7), True), (1, 9, 128, 3, (7, 7), True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(b, n, size, c, out, extreme, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    maps, boxes = _case(b * n + c, b, n, size, c, dtype, extreme)
    before = K.launches
    got = K.multiscale_roi_align_cuda(maps, boxes, (size, size), out)
    assert K.launches == before + 1
    ref = K.multiscale_roi_align_reference(maps, boxes, (size, size), out)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, n, *out, c)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    else:
        f32 = K.multiscale_roi_align_cuda([m.float() for m in maps], boxes, (size, size), out)
        ulp = (f32.abs().clamp(min=1e-30).log2().floor() - 7).exp2()
        assert ((got.float() - f32).abs() <= ulp).all()
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.cuda
def test_pool_multiscale_goes_through_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from object_detectors_tpu_torch.ops.roi_align import pool_multiscale

    maps, boxes = _case(0, 2, 10, 256, 8, torch.bfloat16)
    before = K.launches
    pool_multiscale(maps, boxes, (256, 256))
    assert K.launches == before + 1


# Boxes on a 256 px image: with the P2 map alone, at 7x7, 8 x 17 footprint
# pixels (two slice buffers exactly), 16 x 17 (the stage exactly, one
# buffer), 13 x 21 and 28 x 28 (over it); outside the image, thin,
# degenerate; sides at the LevelMapper boundaries (112, 224, 448)
FOOTPRINT_BOXES = [[10, 10, 76, 34], [10, 10, 76, 72], [10, 10, 92, 54], [10, 10, 130, 130],
                   [10, 10, 250, 250], [10, 10, 90, 166], [5, 5, 60, 60],
                   [-50, -40, 30, 20], [0, 0, 256, 6], [3, 0, 9, 256], [20, 20, 20, 20],
                   [40, 40, 30, 30], [254, 254, 346, 316], [0, 0, 112, 112], [0, 0, 224, 224],
                   [0, 0, 448, 448], [0, 0, 111.99, 112], [7, 3, 231, 227]]


def _assert_matches(got, maps, boxes, size, out, s=2):
    """The tolerances of test_kernel_matches_plain."""
    ref = K.multiscale_roi_align_reference(maps, boxes, (size, size), out, s)
    torch.cuda.synchronize()
    if maps[0].dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    else:
        f32 = K.multiscale_roi_align_cuda([m.float() for m in maps], boxes, (size, size), out, s)
        ulp = (f32.abs().clamp(min=1e-30).log2().floor() - 7).exp2()
        assert ((got.float() - f32).abs() <= ulp).all()
        torch.testing.assert_close(got.float(), ref.float(), rtol=2 ** -7, atol=1e-5)


def _staged_as_the_rule_says(maps, boxes, size, out, s=2):
    """Runs the kernel; checks every RoI's level against assign_fpn_levels
    and its branch against staged_rois. Returns (output, staged [B, N]
    bool, footprint pixels [B, N])."""
    route = torch.empty(boxes.shape[:2], dtype=torch.uint8, device=boxes.device)
    got = K.multiscale_roi_align_cuda(maps, boxes, (size, size), out, s, route=route)
    want, foot = K.staged_rois(maps, boxes, (size, size), out, s)
    torch.cuda.synchronize()
    assert torch.equal((route // 2).int(), assign_fpn_levels(boxes, len(maps)))
    assert torch.equal((route % 2).bool(), want)
    return got, want, foot


@pytest.mark.cuda
@pytest.mark.parametrize("levels,out", [(1, (7, 7)), (1, (14, 14)), (4, (7, 7)), (4, (14, 14))])
@pytest.mark.parametrize("c", [3, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_and_direct_rois_in_one_launch(levels, out, c, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    maps, boxes = _case(levels + c, 1, 40, 256, c, dtype)
    maps = maps[:levels]
    boxes[0, :len(FOOTPRINT_BOXES)] = torch.tensor(FOOTPRINT_BOXES, device=boxes.device)
    got, staged, foot = _staged_as_the_rule_says(maps, boxes, 256, out)
    if levels == 1:
        assert bool((foot > K.STAGE_PIXELS).any())
        if out == (7, 7):  # exactly at the stage, and at two slice buffers
            assert bool((foot == K.STAGE_PIXELS).any())
            assert bool((foot == K.STAGE_PIXELS // 2).any())
        if c == 256:
            assert bool(staged.any()) and not bool(staged.all())
    _assert_matches(got, maps, boxes, 256, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_pixel_level_on_the_card(dtype):
    """A 32 px image: P5 is 1x1 (test_one_pixel_level_follows_the_flat_pooler's case)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    maps, _ = _case(5, 1, 1, 32, 8, dtype)
    boxes = torch.tensor([[[0, 0, 500, 500], [-10, -10, 470, 460], [1, 1, 20, 20]]],
                         dtype=torch.float32).cuda()
    got, staged, _ = _staged_as_the_rule_says(maps, boxes, 32, (7, 7))
    assert bool(staged.all())
    _assert_matches(got, maps, boxes, 32, (7, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("out,s", [((14, 14), 3), ((7, 7), 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_more_samples_an_axis_than_a_warp_has_lanes(out, s, dtype):
    """42 and 35 samples an axis: the kernel numbers a RoI's rows in rounds
    of 32, and a sample count that is not a power of two divides."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    maps, boxes = _case(s, 1, 24, 256, 16, dtype, extreme=True)
    got, staged, _ = _staged_as_the_rule_says(maps, boxes, 256, out, s)
    assert bool(staged.any())
    _assert_matches(got, maps, boxes, 256, out, s)
