"""The RoIAlign kernel (object_detectors_tpu_torch/csrc/roi_align.cu)
against its plain PyTorch version on the GPU. Imports no JAX, so that it
runs on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_roi_align_cuda.py

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
