"""The port's top-k and NMS (object_detectors_tpu_torch/ops/nms.py and the
plain version of kernels/nms.py) against the JAX package's ops/nms.py and
its Pallas nms_pallas kernel (interpret mode) on the same numpy inputs.
Indices, labels and valid flags must be identical, boxes and scores equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.kernels.nms_pallas import nms_pallas
from object_detectors_tpu.ops import boxes as jax_boxes
from object_detectors_tpu.ops import nms as jax_nms
from object_detectors_tpu_torch.kernels import nms as K
from object_detectors_tpu_torch.ops import boxes as B
from object_detectors_tpu_torch.ops import nms as N


def _tied_scores(seed, rows, n):
    # few distinct values, so ties fall across blocks
    return np.random.RandomState(seed).randint(0, 12, (rows, n)).astype(np.float32)


@pytest.mark.parametrize("n,k,block", [
    (1000, 8, 64),    # blocked: 16 blocks > k
    (25200, 256, 64),  # the yolo640 shape
    (100, 8, 64),     # degenerate: 2 blocks <= k
    (6, 8, 64),       # degenerate: k >= n
])
def test_exact_blocked_topk_matches_jax(n, k, block):
    scores = _tied_scores(n, 3, n)
    out_v, out_i = N.exact_blocked_topk(torch.from_numpy(scores), k, block)
    for row in range(scores.shape[0]):
        ref_v, ref_i = jax_nms.exact_blocked_topk(jnp.asarray(scores[row]), k, block)
        np.testing.assert_array_equal(out_i[row].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(out_v[row].numpy(), np.asarray(ref_v))


def test_pairwise_iou_matches_jax():
    rng = np.random.RandomState(0)
    xy = rng.rand(2, 9, 2).astype(np.float32) * 50
    boxes = np.concatenate([xy, xy + rng.rand(2, 9, 2).astype(np.float32) * 30], -1)
    boxes[0, 0, 2:] = boxes[0, 0, :2]  # a zero-area box
    out = B.pairwise_iou(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    for i in range(2):
        ref = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(boxes[i]), jnp.asarray(boxes[i])))
        np.testing.assert_array_equal(out[i], ref)


def _clustered(seed, batch, n, num_classes):
    """Boxes in a few tight clusters, tied scores, random labels and a
    partial valid mask: suppression chains, majority votes and count ties."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(batch, 6, 2) * 200
    which = rng.randint(0, 6, (batch, n))
    cxy = np.take_along_axis(centers, which[..., None], 1) + rng.randn(batch, n, 2) * 4
    wh = 24 + rng.rand(batch, n, 2) * 8
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = (rng.randint(1, 25, (batch, n)) / 25).astype(np.float32)
    labels = rng.randint(0, num_classes, (batch, n)).astype(np.int32)
    valid = rng.rand(batch, n) > 0.2
    return boxes, scores, labels, valid


CASES = [  # (n, max_output, num_classes)
    (64, 100, 4),   # fewer candidates than max_output
    (256, 20, 4),
    (40, 40, 7),
]


@pytest.mark.parametrize("method", ["fixedpoint", "scan"])
@pytest.mark.parametrize("n,max_output,num_classes", CASES)
def test_nms_majority_matches_jax(method, n, max_output, num_classes):
    boxes, scores, labels, valid = _clustered(n, 3, n, num_classes)
    out = N.nms_majority(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(labels), num_classes, 0.6, max_output,
                         valid=torch.from_numpy(valid), method=method)
    out = [t.numpy() for t in out]
    relabeled = 0
    for i in range(boxes.shape[0]):
        ref = jax_nms.nms_majority(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(labels[i]),
            num_classes=num_classes, iou_threshold=0.6, max_output=max_output,
            valid=jnp.asarray(valid[i]), method=method)
        ref = [np.asarray(r) for r in ref]
        np.testing.assert_array_equal(out[3][i], ref[3])  # valid
        np.testing.assert_array_equal(out[2][i], ref[2])  # labels
        np.testing.assert_array_equal(out[0][i], ref[0])  # boxes
        np.testing.assert_array_equal(out[1][i], ref[1])  # scores
        assert 0 < ref[3].sum() < valid[i].sum()  # NMS kept some, dropped some
        src = (ref[0][:, None, :] == boxes[i][None]).all(-1).argmax(1)
        relabeled += int((ref[3] & (ref[2] != labels[i][src])).sum())
    assert relabeled > 0  # the majority vote changed some labels
    assert out[2].dtype == np.int32


@pytest.mark.parametrize("n,max_output,num_classes", CASES)
def test_fixedpoint_equals_scan(n, max_output, num_classes):
    boxes, scores, labels, valid = _clustered(100 + n, 4, n, num_classes)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(labels),
            num_classes, 0.6, max_output, torch.from_numpy(valid))
    for a, b in zip(N.nms_majority(*args, method="fixedpoint"),
                    N.nms_majority(*args, method="scan")):
        assert torch.equal(a, b)


def _hard_case(case):
    """(boxes, scores, labels, valid or None, num_classes, max_output) of one
    of the inputs that stress the fixed point's kept set."""
    if case in ("adversarial chain", "bench clustered"):
        from object_detectors_tpu_torch import bench

        name = "adversarial" if case == "adversarial chain" else "clustered"
        boxes, scores, labels = bench.nms_inputs(name, bs=2, n_cand=64, num_classes=80)
        return boxes, scores, labels.astype(np.int32), None, 80, 40
    if case == "1203 classes":
        boxes, scores, labels, valid = _clustered(11, 2, 300, 1203)
        return boxes, scores, labels, valid, 1203, 300
    boxes, scores, labels, valid = _clustered(12, 2, 96, 5)
    if case == "all scores tied":
        return boxes, np.full_like(scores, 0.5), labels, valid, 5, 50
    if case == "NaN, +inf and -inf scores":
        scores[:, ::7], scores[:, 3::11], scores[:, 5::13] = np.nan, np.inf, -np.inf
        return boxes, scores, labels, None, 5, 50
    assert case == "all invalid"
    return boxes, scores, labels, np.zeros_like(valid), 5, 50


@pytest.mark.parametrize("case", ["adversarial chain", "bench clustered", "1203 classes",
                                  "all scores tied", "NaN, +inf and -inf scores",
                                  "all invalid"])
def test_nms_majority_matches_jax_on_hard_inputs(case):
    """The kept set from the NMS kernel's plain version against JAX's fixed
    point: a suppression chain of depth n/2, the bench's crowded clusters,
    the LVIS class count, exact ties, scores that are not finite (JAX keeps
    only finite scores alive) and no valid box."""
    boxes, scores, labels, valid, num_classes, max_output = _hard_case(case)
    out = N.nms_majority(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(labels), num_classes, 0.6, max_output,
                         valid=None if valid is None else torch.from_numpy(valid))
    out = [t.numpy() for t in out]
    for i in range(boxes.shape[0]):
        ref = [np.asarray(r) for r in jax_nms.nms_majority(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(labels[i]),
            num_classes=num_classes, iou_threshold=0.6, max_output=max_output,
            valid=None if valid is None else jnp.asarray(valid[i]))]
        for o, r in zip(out, ref):  # boxes, scores, labels, valid
            np.testing.assert_array_equal(o[i], r)
    kept = out[3].sum(1)
    if case == "adversarial chain":
        assert (kept == 32).all()  # greedy keeps 0, 2, 4, ...: depth 32 of 64
    elif case == "all invalid":
        assert not out[3].any()
    else:
        assert (kept > 0).all()
    if case == "NaN, +inf and -inf scores":
        kept_scores = out[1][out[3]]
        assert np.isfinite(kept_scores).all()


def test_topk_by_score_matches_lax_top_k():
    """lax.top_k's order: NaN above +inf, +0.0 above -0.0, ties lowest index
    first; k below and at n, and above it refused."""
    x = np.array([[0.5, np.nan, -0.0, 0.0, 0.5, np.inf, -np.inf, 0.25, 0.5, -1.0],
                  [3.0, 3.0, 2.0, -0.0, 3.0, 1.0, 0.0, np.nan, 3.0, 2.0]], np.float32)
    for k in (1, 4, 10):
        values, idx = N.topk_by_score(torch.from_numpy(x), k)
        for row in range(2):
            ref_v, ref_i = jax_nms.topk_by_score(jnp.asarray(x[row]), k)
            np.testing.assert_array_equal(idx[row].numpy(), np.asarray(ref_i))
            np.testing.assert_array_equal(values[row].numpy().view(np.int32),
                                          np.asarray(ref_v).view(np.int32))
    with pytest.raises(ValueError, match="no larger"):  # as lax.top_k
        N.topk_by_score(torch.from_numpy(x), 11)


def test_nms_majority_all_invalid_and_unknown_method():
    boxes, scores, labels, _ = _clustered(5, 2, 16, 3)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(labels), 3)
    ob, osc, olab, ov = N.nms_majority(*args, valid=torch.zeros(2, 16, dtype=torch.bool))
    assert not ov.any() and (olab == -1).all() and (ob == 0).all() and (osc == 0).all()
    with pytest.raises(ValueError):
        N.nms_majority(*args, method="greedy")


def _uniform(seed, groups, n):
    """The candidates of the JAX kernel test: uniform boxes and scores."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(groups, n, 2).astype(np.float32) * 80
    wh = rng.rand(groups, n, 2).astype(np.float32) * 30 + 2
    return (np.concatenate([xy, xy + wh], -1), rng.rand(groups, n).astype(np.float32),
            rng.rand(groups, n) > 0.25)


@pytest.mark.parametrize("n,k", [(64, 16), (128, 100)])
@pytest.mark.parametrize("masked", [False, True])
def test_greedy_nms_matches_nms_pallas_and_select_max(n, k, masked):
    boxes, scores, valid = _uniform(1, 3, n)
    keep, ok = N.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, k,
                            torch.from_numpy(valid) if masked else None)
    assert keep.dtype == torch.int32 and keep.shape == ok.shape == (3, k)
    for g in range(3):
        v = jnp.asarray(valid[g]) if masked else None
        ki_p, v_p = nms_pallas(jnp.asarray(boxes[g]), jnp.asarray(scores[g]), 0.5, k,
                               valid=v, interpret=True)
        s = np.where(valid[g], scores[g], -np.inf) if masked else scores[g]
        ki_s, v_s = jax_nms._select_max_nms(jnp.asarray(boxes[g]), jnp.asarray(s), 0.5, k)
        np.testing.assert_array_equal(ok[g].numpy(), np.asarray(v_p))
        np.testing.assert_array_equal(keep[g].numpy(), np.asarray(ki_p))
        np.testing.assert_array_equal(ok[g].numpy(), np.asarray(v_s))
        np.testing.assert_array_equal(keep[g].numpy(), np.where(np.asarray(v_s),
                                                                np.asarray(ki_s), -1))


def test_greedy_nms_ties_dead_boxes_and_empty_groups():
    boxes = np.array([[0, 0, 10, 10], [0, 0, 10, 10], [30, 30, 40, 40], [1, 0, 11, 10],
                      [30, 30, 40, 40]], np.float32)
    scores = np.array([0.5, 0.5, 0.5, 0.9, -np.inf], np.float32)
    b = torch.from_numpy(np.stack([boxes] * 3))
    s = torch.from_numpy(np.stack([scores, scores, np.full(5, -np.inf, np.float32)]))
    s[1, 0] = float("nan")
    keep, ok = N.greedy_nms(b, s, 0.5, 4)
    # equal scores go lowest index first; NaN and -inf are dead
    assert keep.tolist() == [[3, 2, -1, -1], [3, 2, -1, -1], [-1] * 4]
    assert ok.tolist() == [[True, True, False, False]] * 2 + [[False] * 4]
    ki_p, v_p = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 4, interpret=True)
    assert np.asarray(ki_p)[np.asarray(v_p)].tolist() == [3, 2]
    keep, ok = N.greedy_nms(torch.zeros(2, 0, 4), torch.zeros(2, 0), 0.5, 3)
    assert keep.tolist() == [[-1] * 3] * 2 and not ok.any()


@pytest.mark.parametrize("n,max_output", [(300, 100), (600, 600), (40, 64)])
def test_nms_matches_jax(n, max_output):
    boxes, scores, labels, valid = _clustered(200 + n, 2, n, 4)
    out = [t.numpy() for t in N.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                                    max_output, torch.from_numpy(valid))]
    for i in range(2):
        ref = [np.asarray(r) for r in jax_nms.nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.5, max_output,
            jnp.asarray(valid[i]))]
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o[i], r)
        assert 0 < ref[3].sum() < valid[i].sum()


@pytest.mark.parametrize("n,max_output", [(300, 100), (1000, 100)])
@pytest.mark.parametrize("masked", [False, True])
def test_batched_nms_matches_jax(n, max_output, masked):
    boxes, scores, labels, valid = _clustered(300 + n, 2, n, 5)
    v = torch.from_numpy(valid) if masked else None
    out = [t.numpy() for t in N.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                            torch.from_numpy(labels), 0.5, max_output, v)]
    for i in range(2):
        ref = [np.asarray(r) for r in jax_nms.batched_nms(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), jnp.asarray(labels[i]), 0.5,
            max_output, jnp.asarray(valid[i]) if masked else None)]
        for o, r in zip(out, ref):  # boxes, scores, labels, keep_idx, valid
            np.testing.assert_array_equal(o[i], r)
        assert ref[4].sum() > 0


@pytest.mark.parametrize("n,seed", [(300, 0), (700, 1)])
def test_fixedpoint_keep_matches_jax(n, seed):
    """N > 256 sends the JAX fixed point down its chunked branch."""
    boxes, scores, _, valid = _clustered(400 + seed, 3, n, 3)
    scores = np.where(valid, scores, -np.inf).astype(np.float32)
    out = N.fixedpoint_keep(torch.from_numpy(boxes), torch.from_numpy(scores), 0.7)
    for i in range(3):
        ref, converged = jax_nms._fixedpoint_keep(jnp.asarray(boxes[i]),
                                                  jnp.asarray(scores[i]), 0.7)
        assert bool(converged)
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(ref))
        assert 0 < out[i].sum() < valid[i].sum()


def test_greedy_nms_cuda_wrapper_checks_its_inputs():
    boxes, scores, valid = _uniform(1, 2, 16)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    with pytest.raises(ValueError, match="CUDA"):
        K.greedy_nms_cuda(b, s, 0.5, 4)
    with pytest.raises(TypeError, match="float32"):
        K.greedy_nms_cuda(b.double(), s, 0.5, 4)
    with pytest.raises(ValueError, match="valid"):
        K.greedy_nms_cuda(b, s, 0.5, 4, valid=torch.from_numpy(valid).int())
    with pytest.raises(ValueError, match="boxes"):
        K.greedy_nms_cuda(b[0], s, 0.5, 4)


@pytest.mark.parametrize("groups,n,words", [(80, 1000, 16), (16, 2000, 32), (16, 1000, 16),
                                            (3, 1, 2), (3, 63, 2), (3, 64, 2), (3, 65, 2),
                                            (3, 129, 4), (1, 4096, 64), (2, 0, 0)])
def test_greedy_nms_kernel_scratch(groups, n, words):
    """The NMS kernel's scratch: sorted order, boxes, areas and live counts
    per group, and one bit per later box in ceil(n / 64) words a row,
    rounded up to even: 10 MB at the RPN call (80 x 1000), 8 MB at
    RetinaNet's (16 x 2000)."""
    nbytes, (order, boxes, area, live, mask) = K.scratch_layout(groups, n)
    assert words % 2 == 0 and words - 2 < -(-n // K.CHUNK) <= words
    parts = sorted([(mask, groups * n * words * 8), (boxes, groups * n * 16),
                    (order, groups * n * 4), (area, groups * n * 4), (live, groups * 4)])
    assert mask == 0 and all(off % 16 == 0 for off, _ in parts)
    for (off, size), (nxt, _) in zip(parts, parts[1:] + [(nbytes, 0)]):
        assert off + size <= nxt  # no part overlaps the next
    assert nbytes < sum(size for _, size in parts) + 16 * len(parts)
    if (groups, n) in ((80, 1000), (16, 2000)):
        assert groups * n * words * 8 in (10_240_000, 8_192_000)
