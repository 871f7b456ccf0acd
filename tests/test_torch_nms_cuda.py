"""The greedy NMS kernel (object_detectors_tpu_torch/csrc/nms.cu) against
its plain PyTorch version on the GPU: kept indices and valid flags must be
identical. Imports no JAX, so that it runs on a machine with a card and
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_nms_cuda.py
"""

import numpy as np
import pytest
import torch

from object_detectors_tpu_torch.kernels import nms as K


def _clustered(seed, groups, n, size=640.0):
    rng = np.random.RandomState(seed)
    centers = rng.rand(groups, 8, 2) * size
    which = rng.randint(0, 8, (groups, n))
    cxy = np.take_along_axis(centers, which[..., None], 1) + rng.randn(groups, n, 2) * 6
    wh = 40 + rng.rand(groups, n, 2) * 20
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = (rng.randint(1, 50, (groups, n)) / 50).astype(np.float32)  # exact ties
    valid = rng.rand(groups, n) > 0.2
    return [torch.from_numpy(a).cuda() for a in (boxes, scores, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("groups,n,k,thr", [(80, 1000, 1000, 0.7), (16, 1000, 100, 0.5),
                                            (3, 1, 5, 0.5), (2, 4096, 300, 0.5),
                                            (5, 37, 37, 0.3)])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_equals_plain(groups, n, k, thr, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    boxes, scores, valid = _clustered(groups + n, groups, n)
    v = valid if masked else None
    before = K.launches
    keep, ok = K.greedy_nms_cuda(boxes, scores, thr, k, v)
    assert K.launches == before + 1
    ref_keep, ref_ok = K.greedy_nms_reference(boxes, scores, thr, k, v)
    torch.cuda.synchronize()
    assert torch.equal(keep, ref_keep) and torch.equal(ok, ref_ok)


@pytest.mark.cuda
def test_kernel_all_dead_and_too_many_boxes():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    boxes, scores, _ = _clustered(0, 4, 100)
    keep, ok = K.greedy_nms_cuda(boxes, torch.full_like(scores, float("-inf")), 0.5, 10)
    assert (keep == -1).all() and not ok.any()
    keep, ok = K.greedy_nms_cuda(boxes, scores, 0.5, 10, torch.zeros_like(scores, dtype=torch.bool))
    assert (keep == -1).all() and not ok.any()
    big = K.max_boxes() + 1
    with pytest.raises(ValueError, match="at most"):
        K.greedy_nms_cuda(torch.zeros(1, big, 4, device="cuda"), torch.zeros(1, big, device="cuda"),
                          0.5, 10)
