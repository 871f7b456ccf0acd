"""Exact top-k selection (port of the JAX package's ``ops/selection.py``).

The contract is the JAX one, index for index and in the same output order:

* k < n: the exact top-k SET, ties at the k-th value broken lowest index
  first (``lax.top_k``'s rule), -0.0 equal to +0.0 (and returned as +0.0),
  NaN ordered below every real value including -inf. The set comes out in
  the order of the JAX ``_pack_topk``: by 128-lane row (index // 128)
  ascending, then by value descending, then by index ascending.
* k >= n: ``lax.top_k`` of the whole row: descending in IEEE total order
  (NaN above +inf, +0.0 above -0.0), equal values lowest index first.

Callers depend on this order: the RetinaNet second-stage select and the
pre-NMS caps break ties by position. The JAX version finds the set with a
radix search over integer codes, a TPU device; here one stable sort over
the same order-isomorphic codes selects it, and a second sort of the k
winners puts them in the JAX order. Rows of a batched input are
independent.
"""

from __future__ import annotations

from typing import Sequence

import torch

LANES = 128  # the JAX version's row width (radix_topk's ``lanes``)
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _total_order_code(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 code in IEEE total order (-NaN < -inf < ... < -0 <
    +0 < ... < +inf < +NaN), the order ``lax.top_k`` sorts by."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def _order_code(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 code of the radix order (NaN lowest, -0 == +0)."""
    code = _total_order_code(torch.where(x == 0, torch.zeros_like(x), x))
    return torch.where(torch.isnan(x), torch.ones_like(code), code)


def radix_topk(scores: torch.Tensor, k: int):
    """Exact top-k over the last dim of float scores [..., n].

    Returns (values [..., k'], indices [..., k'] int64), k' = min(k, n), in
    the JAX order (module docstring).
    """
    if scores.dtype not in _BITS:
        raise TypeError(f"radix_topk: unsupported dtype {scores.dtype}")
    n = scores.shape[-1]
    x = scores.float()
    # values are gathered as raw bits: a bf16 gather on the CPU rewrites NaNs
    bits = scores.view(_BITS[scores.dtype])
    if k >= n:
        idx = torch.sort(_total_order_code(x), dim=-1, descending=True, stable=True).indices
        return torch.gather(bits, -1, idx).view(scores.dtype), idx
    idx = torch.sort(_order_code(x), dim=-1, descending=True, stable=True).indices[..., :k]
    # idx is in (value desc, index asc) order; regroup by 128-lane row and
    # keep that order inside each row
    rank = torch.arange(k, device=idx.device)
    idx = torch.gather(idx, -1, torch.argsort(idx // LANES * k + rank, dim=-1))
    values = torch.gather(bits, -1, idx)
    negative_zero = torch.iinfo(values.dtype).min  # the sign bit alone
    return torch.where(values == negative_zero, 0, values).view(scores.dtype), idx


def radix_topk_multi(scores_list: Sequence[torch.Tensor], ks: Sequence[int]):
    """``radix_topk`` of several independent score tensors: a list of
    (values, indices), one per (scores, k) pair."""
    if len(scores_list) != len(ks):
        raise ValueError("radix_topk_multi needs one k per score tensor")
    return [radix_topk(s, k) for s, k in zip(scores_list, ks)]


def radix_topk_masked(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """``radix_topk`` of the scores where ``valid``, -inf elsewhere (the
    pre-NMS pattern): an invalid entry is selected only when fewer than k
    are valid, and carries -inf."""
    return radix_topk(torch.where(valid, scores, float("-inf")), k)
