"""Exact top-k selection (port of the JAX package's ``ops/selection.py``).

The contract is the JAX one: the exact top-k SET, ties at the k-th value
broken lowest index first (``lax.top_k``'s rule), -0.0 equal to +0.0, NaN
ordered below every real value including -inf. The JAX version finds the
set with a radix search over integer codes, a TPU device; here one stable
sort over the same order-isomorphic codes selects it, and the output comes
in descending order (the JAX order is (128-lane row, rank in row); no
caller depends on either).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _order_code(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 code with the same order (NaN lowest, -0 == +0)."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    code = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(torch.isnan(x), torch.ones_like(code), code)


def radix_topk(scores: torch.Tensor, k: int):
    """Exact top-k over the last dim of float32 scores [..., n].

    Returns (values [..., k'], indices [..., k'] int64), k' = min(k, n),
    in descending order, equal values lowest index first.
    """
    code = _order_code(scores.float())
    idx = torch.sort(code, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(scores, -1, idx), idx


def radix_topk_multi(scores_list: Sequence[torch.Tensor], ks: Sequence[int]):
    """``radix_topk`` of several independent score tensors: a list of
    (values, indices), one per (scores, k) pair."""
    if len(scores_list) != len(ks):
        raise ValueError("radix_topk_multi needs one k per score tensor")
    return [radix_topk(s, k) for s, k in zip(scores_list, ks)]
