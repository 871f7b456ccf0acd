"""Balanced positive / negative sampling (port of the JAX package's
``ops/sampler.py``, torchvision BalancedPositiveNegativeSampler semantics):
up to ``batch_size_per_image * positive_fraction`` positives, the rest
negatives, uniformly without replacement.

Each candidate of a polarity gets a uniform score and the ``k`` highest are
kept, so the shapes stay [..., N] masks. The uniforms come from an explicit
``torch.Generator``, or are given: the tests hand in the draws of the JAX
sampler (two [N] uniforms an image, for its positives and its negatives).
Above one process every rank draws the global batch's uniforms from the
same generator and keeps the rows of its own images, so that the ranks
together sample what one process sampling the global batch would.
"""

from __future__ import annotations

import torch

from object_detectors_tpu_torch.parallel import mesh


def _topk_mask_by_score(score: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[..., N] mask of the ``k`` [...] highest scores; -inf marks the
    ineligible. Equal scores rank by index, as JAX's stable argsort of
    -score."""
    order = torch.sort(-score, dim=-1, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        -1, order, torch.arange(score.shape[-1], device=score.device).expand_as(order))
    return (ranks < k[..., None]) & torch.isfinite(score)


def sampler_uniforms(shape, device, generator: torch.Generator | None = None):
    """The (positive, negative) uniforms of ``balanced_sample`` for labels of
    ``shape`` [B, N], drawn from ``generator``. Above one process each draw
    is the global batch's [B * world, N], of which the rank keeps rows
    rank, rank + world, ...: the places of its images in the global batch,
    which ``data/coco.py:shard_indices`` deals out round-robin."""
    world, rank = mesh.process_count(), mesh.process_index()
    full = (shape[0] * world,) + tuple(shape[1:])
    return tuple(torch.rand(full, generator=generator, device=device)[rank::world]
                 for _ in range(2))


def balanced_sample(labels: torch.Tensor, batch_size_per_image: int,
                    positive_fraction: float, uniforms=None,
                    generator: torch.Generator | None = None):
    """labels [..., N]: >= 1 positive, 0 negative, < 0 ignored. ``uniforms``
    (u_pos, u_neg), each [..., N] in [0, 1), or drawn from ``generator``.
    -> (pos_mask, neg_mask) [..., N] bool."""
    is_pos = labels >= 1
    is_neg = labels == 0
    max_pos = int(batch_size_per_image * positive_fraction)
    num_pos = is_pos.sum(-1).clamp(max=max_pos)
    num_neg = torch.minimum(is_neg.sum(-1), batch_size_per_image - num_pos)
    u_pos, u_neg = uniforms if uniforms is not None else sampler_uniforms(
        labels.shape, labels.device, generator)
    pos_score = torch.where(is_pos, u_pos, float("-inf"))
    neg_score = torch.where(is_neg, u_neg, float("-inf"))
    return _topk_mask_by_score(pos_score, num_pos), _topk_mask_by_score(neg_score, num_neg)
