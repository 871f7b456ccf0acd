"""The port's exact top-k (object_detectors_tpu_torch/ops/selection.py)
against the JAX package's ops/selection.py: the same indices in the same
order, and the same values, at k < n (the radix path: by 128-lane row, then
value), at k >= n (``lax.top_k`` order), over batched rows, with bf16 ties,
signed zeros, -inf and NaN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.ops import selection as jax_sel
from object_detectors_tpu_torch.ops import selection as SEL


def _scores(seed, rows, n, special=True):
    """Few distinct values (many ties across 128-lane rows) and, with
    ``special``, -inf, NaN and signed zeros on some rows."""
    rng = np.random.RandomState(seed)
    s = (rng.randint(0, 40, (rows, n)) / 7).astype(np.float32)
    if special:
        s[0, ::5] = -np.inf
        s[1 % rows, ::7] = np.nan
        s[2 % rows, :20] = -0.0
        s[2 % rows, 20:40] = 0.0
    return s


def _both(scores: np.ndarray, dtype):
    """The same scores for JAX and for torch, bit for bit (torch and JAX
    round NaN to bf16 with different sign bits, so the bf16 bits go across)."""
    ref = jnp.asarray(scores, dtype=str(dtype)[6:])
    if dtype == torch.bfloat16:
        bits = np.asarray(ref.view(jnp.uint16)).view(np.int16)
        return ref, torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return ref, torch.from_numpy(scores)


def _assert_rows_match(scores, k, dtype):
    ref_in, x = _both(scores, dtype)
    out_v, out_i = SEL.radix_topk(x, k)
    for row in range(scores.shape[0]):
        ref_v, ref_i = jax_sel.radix_topk(ref_in[row], k)
        np.testing.assert_array_equal(out_i[row].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(_bits(out_v[row]), np.asarray(ref_v).view(_UINT[dtype]))


_UINT = {torch.float32: np.uint32, torch.bfloat16: np.uint16}


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a float tensor (NaN signs and -0.0 included)."""
    signed = torch.int32 if t.dtype == torch.float32 else torch.int16
    return t.view(signed).numpy().view(_UINT[t.dtype])


@pytest.mark.parametrize("n,k", [(5000, 1000), (700, 64), (129, 128), (300, 1000),
                                 (40, 40), (1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_radix_topk_matches_jax_in_order(n, k, dtype):
    _assert_rows_match(_scores(n, 3, n), k, dtype)


def test_radix_topk_nan_rows():
    """All NaN, NaN beside -inf, fewer non-NaN scores than k."""
    s = np.full((3, 300), np.nan, np.float32)
    s[1, :150] = -np.inf
    s[2, ::3] = np.arange(100, dtype=np.float32)
    for k in (10, 200, 299, 300):
        _assert_rows_match(s, k, torch.float32)


def test_radix_topk_bf16_second_stage_order():
    """5000 bf16-valued scores, top-1000, then a top-1000 over the 4-class
    rows of the winners (the RetinaNet two-stage select): the (anchor,
    class) pairs equal JAX's only if the first stage's order does."""
    rng = np.random.RandomState(3)
    best_ref, best = _both(rng.randn(5000).astype(np.float32) * 0.5, torch.bfloat16)
    sub_ref, sub = _both(rng.randn(5000, 4).astype(np.float32) * 0.5, torch.bfloat16)
    _, a_ref = jax_sel.radix_topk(best_ref, 1000)
    _, i_ref = jax_sel.radix_topk(sub_ref[a_ref].reshape(-1), 1000)
    _, a = SEL.radix_topk(best, 1000)
    _, i = SEL.radix_topk(sub[a].reshape(-1), 1000)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_radix_topk_multi_matches_jax_in_order():
    rng = np.random.RandomState(4)
    rows = [(rng.randint(0, 30, n) / 3).astype(np.float32) for n in (1728, 432, 108, 12)]
    ks = (64, 64, 200, 12)
    out = SEL.radix_topk_multi([torch.from_numpy(r) for r in rows], ks)
    ref = jax_sel.radix_topk_multi(tuple(jnp.asarray(r) for r in rows), ks)
    for (ov, oi), (rv, ri) in zip(out, ref):
        np.testing.assert_array_equal(oi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(_bits(ov), np.asarray(rv).view(np.uint32))
    with pytest.raises(ValueError, match="one k per"):
        SEL.radix_topk_multi([torch.zeros(3)], (1, 2))


@pytest.mark.parametrize("n,k,share", [(700, 64, 0.5), (300, 100, 0.2), (40, 40, 0.7)])
def test_radix_topk_masked_matches_jax(n, k, share):
    """Scores where valid, -inf elsewhere; at share 0.2 fewer than k are
    valid, so -inf entries are selected."""
    scores = _scores(n + 1, 3, n)
    valid = np.random.RandomState(n).rand(3, n) < share
    out_v, out_i = SEL.radix_topk_masked(torch.from_numpy(scores), torch.from_numpy(valid), k)
    for row in range(3):
        ref_v, ref_i = jax_sel.radix_topk_masked(jnp.asarray(scores[row]),
                                                 jnp.asarray(valid[row]), k)
        np.testing.assert_array_equal(out_i[row].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(_bits(out_v[row]), np.asarray(ref_v).view(np.uint32))
    if share == 0.2:
        assert torch.isneginf(out_v).any()
