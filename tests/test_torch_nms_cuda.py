"""The greedy NMS kernel (object_detectors_tpu_torch/csrc/nms.cu) against
its plain PyTorch version on the GPU: kept indices and valid flags must be
identical, across one to 64 mask chunks, with K below, at and above the
kept count and the K-th kept box on either side of a chunk boundary. Imports
no JAX, so that it runs on a machine with a card and without JAX:

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


def _spread(seed, groups, n, size=640.0):
    """Boxes spread over the image with distinct scores: most are kept, so
    the kept set runs through every 64-box chunk."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(groups, n, 2) * size
    wh = 10 + rng.rand(groups, n, 2) * 60
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (boxes, rng.rand(groups, n).astype(np.float32))]


def _assert_equal_for_ks(boxes, scores, thr, ks, valid=None):
    """The kernel at every K equals the plain version's first K kept boxes."""
    ref_keep, ref_ok = K.greedy_nms_reference(boxes, scores, thr, max(ks), valid)
    for k in ks:
        keep, ok = K.greedy_nms_cuda(boxes, scores, thr, k, valid)
        torch.cuda.synchronize()
        assert torch.equal(keep, ref_keep[:, :k]) and torch.equal(ok, ref_ok[:, :k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 2000, 4096])
def test_kernel_equals_plain_at_every_chunk_count(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    boxes, scores = _spread(n, 3, n)
    keep, ok = K.greedy_nms_reference(boxes, scores, 0.5, n)
    kept = int(ok.sum(1).min())
    # greedy position of each kept box of group 0, to put the K-th kept box
    # on the last place of a 64-box chunk and on the first of the next
    order = torch.sort(scores[0], descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device)
    pos = rank[keep[0][ok[0]].long()]
    edge = [int((pos < 64 * c).sum()) for c in range(1, n // 64 + 1)]
    ks = {1, max(kept - 1, 1), kept, kept + 1, n, n + 5}
    ks |= {e + d for e in edge[:3] for d in (0, 1) if e + d >= 1}
    _assert_equal_for_ks(boxes, scores, 0.5, sorted(ks))


@pytest.mark.cuda
def test_kernel_ties_nan_dead_and_uneven_live_counts():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    boxes, scores, valid = _clustered(11, 4, 700)
    tied = torch.full_like(scores, 0.5)
    nan = scores.clone()
    nan[:, ::3] = float("nan")
    uneven = scores.clone()
    uneven[0, 10:] = float("-inf")   # 10 live boxes
    uneven[1] = float("-inf")        # none
    uneven[2, 130:] = float("-inf")  # three chunks, the last one partly
    for s in (tied, nan, uneven, torch.full_like(scores, float("-inf"))):
        _assert_equal_for_ks(boxes, s, 0.5, [1, 64, 100, 700])
    _assert_equal_for_ks(boxes, scores, 0.5, [5, 700], torch.zeros_like(valid))
    _assert_equal_for_ks(boxes, uneven, 0.5, [64, 700], valid)


@pytest.mark.cuda
def test_kernel_at_the_retinanet_shape():
    """16 x 2000 candidates, K 300, boxes offset by class as batched_nms
    offsets them: boxes of different classes never overlap."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    boxes, scores, _ = _clustered(12, 16, 2000)
    labels = torch.from_numpy(np.random.RandomState(13).randint(0, 91, (16, 2000))).cuda()
    offset = labels.float()[..., None] * (boxes.amax(dim=(1, 2))[:, None, None] + 1.0)
    _assert_equal_for_ks((boxes + offset).contiguous(), scores, 0.5, [300])


def _majority_inputs(case):
    """(boxes, scores, labels, valid or None, num_classes, max_output) on the
    card at the shapes majority-vote NMS takes on the port's paths."""
    from object_detectors_tpu_torch.bench import nms_inputs

    if case in ("uniform", "clustered", "adversarial"):  # the bench's, 512 x 256
        boxes, scores, labels = (torch.from_numpy(a).cuda() for a in nms_inputs(case))
        return boxes, scores, labels, None, 80, 100
    groups, n, classes, k = {"yolo640": (128, 256, 80, 100), "serving yolo": (64, 512, 80, 100),
                             "yolo_lvis416": (16, 300, 1203, 300)}[case]
    boxes, scores, valid = _clustered(groups + n, groups, n)
    labels = torch.from_numpy(np.random.RandomState(n).randint(0, classes, (groups, n))).cuda()
    return boxes, scores, labels, valid, classes, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["yolo640", "serving yolo", "yolo_lvis416", "uniform",
                                  "clustered", "adversarial"])
def test_nms_majority_takes_its_kept_set_from_one_launch(case):
    """nms_majority on the card: identical to the scan method, one NMS
    kernel launch a call and no host sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from object_detectors_tpu_torch.ops.nms import nms_majority

    boxes, scores, labels, valid, classes, k = _majority_inputs(case)
    args = (boxes, scores, labels, classes, 0.6, k, valid)
    nms_majority(*args)  # builds and loads the kernel
    torch.cuda.synchronize()
    before = K.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        fixed = nms_majority(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert K.launches == before + 1
    scan = nms_majority(*args, method="scan")
    assert all(torch.equal(a, b) for a, b in zip(fixed, scan))
    assert bool(fixed[3].any())
