"""GT <-> prediction matching with static padded shapes (port of the JAX
package's ``ops/matcher.py``, torchvision Matcher semantics): three-way
thresholding (a GT index / BETWEEN_THRESHOLDS / BELOW_LOW_THRESHOLD) with
the optional low-quality recovery (every GT keeps its best predictions,
ties included), SSD's single-threshold match with each GT's forced best
prediction, and YOLO's best-prior assignment. GT is padded to a fixed M
with a validity mask, so a match is one [..., M, N] reduction."""

from __future__ import annotations

import torch

from object_detectors_tpu_torch.ops import boxes as box_ops

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match(match_quality: torch.Tensor, gt_valid: torch.Tensor, high_threshold: float,
          low_threshold: float, allow_low_quality_matches: bool = False) -> torch.Tensor:
    """Quality [..., M, N] between M padded GTs and N predictions, gt_valid
    [..., M] -> [..., N] int64: the best valid GT's index, or -1 (below
    ``low_threshold``) or -2 (between the thresholds). The best GT is the
    first of equal maxima, as jnp.argmax."""
    quality = torch.where(gt_valid[..., None], match_quality, float("-inf"))
    matched_vals = quality.amax(-2)
    all_matches = quality.argmax(-2)
    matches = torch.where(matched_vals < low_threshold, BELOW_LOW_THRESHOLD, all_matches)
    matches = torch.where((matched_vals >= low_threshold) & (matched_vals < high_threshold),
                          BETWEEN_THRESHOLDS, matches)
    if allow_low_quality_matches:
        # each valid GT's best predictions (ties included) keep their match
        highest_per_gt = quality.max(-1, keepdim=True).values
        best_for_some_gt = ((quality == highest_per_gt) & gt_valid[..., None]
                            & torch.isfinite(highest_per_gt)).any(-2)
        matches = torch.where(best_for_some_gt, all_matches, matches)
    return matches


def ssd_match(match_quality: torch.Tensor, gt_valid: torch.Tensor,
              threshold: float = 0.5) -> torch.Tensor:
    """SSDMatcher: ``match`` at one threshold, then each valid GT claims
    its best prediction (the first of equal maxima). Where two GTs claim
    the same prediction the higher GT index wins (a scatter-max, as the
    JAX ``ssd_match``). Quality [..., M, N] -> [..., N] int64."""
    matches = match(match_quality, gt_valid, threshold, threshold, False)
    quality = torch.where(gt_valid[..., None], match_quality, float("-inf"))
    best_pred = quality.argmax(-1)  # [..., M]
    ids = torch.arange(match_quality.shape[-2], device=matches.device).expand_as(best_pred)
    claim = torch.full_like(matches, -10_000_000)
    claim.scatter_reduce_(-1, best_pred, torch.where(gt_valid, ids, -10_000_000), "amax")
    return torch.where(claim >= 0, claim, matches)


def yolo_best_prior_match(gt_boxes: torch.Tensor, priors: torch.Tensor,
                          iou_type: int = 0) -> torch.Tensor:
    """Each GT [..., M, 4] cxcywh (relative) claims the prior [P, 4] of
    highest IoU -> [..., M] int64 (the first of equal maxima)."""
    iou = box_ops.box_iou(gt_boxes[..., :, None, :], priors, iou_type=iou_type)
    return iou.argmax(-1)
