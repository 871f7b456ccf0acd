"""Top-k selection and NMS: greedy, class-aware and majority-vote.

Port of the JAX package's ``ops/nms.py`` (``exact_blocked_topk``, ``nms``,
``batched_nms``, the fixed-point kept set, ``nms_majority`` with its
fixed-point and scan methods, ``topk_by_score``), written over a leading batch dimension where
the JAX code ``vmap``s per image. The greedy kept sets come from
``greedy_nms``: the hand-written kernel of ``kernels/nms.py`` for a CUDA
tensor, its plain version for a CPU tensor. Greedy NMS has one kept set,
so this equals the JAX fixed point without a loop on the host.

Ties follow ``lax.top_k`` and ``jnp.argsort``: equal values keep the lower
index first. ``torch.topk`` promises no tie order, so selections here go
through stable sorts (``topk_lowest_index``).
"""

from __future__ import annotations

import torch

from object_detectors_tpu_torch.kernels import nms as nms_kernel
from object_detectors_tpu_torch.ops.boxes import pairwise_iou
from object_detectors_tpu_torch.ops.selection import _total_order_code


def topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k over the last dim, descending, equal values in index order."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def topk_by_score(scores: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim (the JAX ``topk_by_score``): the k
    largest values, descending in IEEE total order (NaN above +inf, +0.0
    above -0.0), equal values lowest index first; k > n raises, as there."""
    if k > scores.shape[-1]:
        raise ValueError(f"k must be no larger than the last dim, got k={k} for "
                         f"{tuple(scores.shape)}")
    idx = torch.sort(_total_order_code(scores.float()), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(scores, -1, idx), idx


def exact_blocked_topk(scores: torch.Tensor, k: int, block: int = 64):
    """Exact top-k over [B, n] scores via block maxima.

    The k largest entries lie in at most k blocks, each with block max >=
    the k-th value, so the k blocks with the largest maxima hold them all.
    Ties across blocks resolve block-major, as in the JAX version. Returns
    (values [B, k'], indices [B, k']) with k' = min(k, n).
    """
    n = scores.shape[-1]
    nb = -(-n // block)
    if k >= n or nb <= k:  # degenerate: blocking cannot help
        return topk_lowest_index(scores, min(k, n))
    pad = nb * block - n
    s = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    blocks = s.reshape(*s.shape[:-1], nb, block)
    _, bidx = topk_lowest_index(blocks.amax(-1), k)
    bidx, _ = torch.sort(bidx, dim=-1)  # block-major order for tie parity
    sub = torch.gather(blocks, -2, bidx[..., None].expand(*bidx.shape, block))
    topv, subi = topk_lowest_index(sub.reshape(*sub.shape[:-2], k * block), k)
    idx = torch.gather(bidx, -1, subi // block) * block + subi % block
    return topv, idx


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, n, ...], idx [B, k] -> x[b, idx[b]] [B, k, ...]."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(shape)
    return torch.gather(x, 1, flat)


def _finish(kept_scores, boxes, labels, max_output):
    """Top max_output of the kept set -> padded (boxes, scores, labels, valid)."""
    bsz, n = kept_scores.shape
    k = min(max_output, n)
    topv, topi = topk_lowest_index(kept_scores, k)
    valid = torch.isfinite(topv)
    if k < max_output:
        pad = max_output - k
        topi = torch.cat([topi, topi.new_zeros(bsz, pad)], 1)
        topv = torch.cat([topv, topv.new_full((bsz, pad), float("-inf"))], 1)
        valid = torch.cat([valid, valid.new_zeros(bsz, pad)], 1)
    out_boxes = torch.where(valid[..., None], gather_rows(boxes, topi), 0.0)
    out_scores = torch.where(valid, topv, 0.0)
    out_labels = torch.where(valid, gather_rows(labels, topi), -1)
    return out_boxes, out_scores, out_labels, valid


def _majority_nms_fixedpoint(boxes, scores, labels, num_classes, iou_threshold,
                             max_output):
    """Kept set as the fixed point of "alive and not overlapped by an earlier
    kept box", then each suppressed box joins the cluster of the first kept
    box (score order) that overlaps it: the step where the sequential scan
    removed it. Scores of -inf mark invalid boxes; as in JAX, a box is alive
    when its score is finite (+inf and NaN are dead too).

    That fixed point is the greedy kept set in stable score order, so it
    comes from one ``fixedpoint_keep`` call on the sorted boxes (one launch
    of the NMS kernel on a CUDA tensor): no loop and no sync on the host."""
    bsz, n = scores.shape
    order = torch.sort(-scores, dim=1, stable=True).indices
    b = gather_rows(boxes, order)
    s = torch.gather(scores, 1, order)
    lab = torch.gather(labels, 1, order)
    alive = torch.isfinite(s)
    idx = torch.arange(n, device=scores.device)
    earlier = idx[None, :] < idx[:, None]                   # [j, i]: i before j
    over = ((pairwise_iou(b, b) > iou_threshold) & earlier
            & alive[:, :, None] & alive[:, None, :])        # [B, j, i]
    # the kernel keeps equal scores in index order: on the stably sorted
    # input, JAX's argsort order
    kept = fixedpoint_keep(b, s, iou_threshold, valid=alive)

    cand = over & kept[:, None, :]
    first_i = torch.argmax(cand.to(torch.int32) * (n - idx), dim=-1)  # [B, j]
    assigned = ~kept & alive & cand.any(-1)
    flat = ((torch.arange(bsz, device=scores.device)[:, None] * n + first_i)
            * num_classes + lab.clamp(0, num_classes - 1))
    counts = torch.zeros(bsz * n * num_classes, dtype=torch.int32,
                         device=scores.device)
    counts.scatter_add_(0, flat.reshape(-1), assigned.reshape(-1).to(torch.int32))
    counts = counts.view(bsz, n, num_classes)
    n_unique = (counts > 0).sum(-1)
    majority = torch.argmax(counts, dim=-1).to(lab.dtype)  # ties: smallest id
    out_lab = torch.where(kept & (n_unique > 1), majority, lab)
    return _finish(torch.where(kept, s, float("-inf")), b, out_lab, max_output)


def _majority_nms_scan(boxes, scores, labels, num_classes, iou_threshold,
                       max_output):
    """Sequential max_output-step select-max majority NMS: the reference
    method, kept as the oracle of the fixed point."""
    bsz, n = scores.shape
    dev = scores.device
    iou = pairwise_iou(boxes, boxes)
    col = torch.arange(n, device=dev)
    rows = torch.arange(bsz, device=dev)
    labels_c = labels.clamp(0, num_classes - 1).long()
    alive = scores.clone()
    keep, ok_all, lab_all = [], [], []
    for _ in range(max_output):
        i = torch.argmax(alive, dim=1)
        ok = torch.isfinite(alive[rows, i])
        newly = (torch.isfinite(alive) & (iou[rows, i] > iou_threshold)
                 & (col[None, :] != i[:, None]))
        counts = torch.zeros(bsz, num_classes, dtype=torch.int32, device=dev)
        counts.scatter_add_(1, labels_c, newly.to(torch.int32))
        n_unique = (counts > 0).sum(-1)
        majority = torch.argmax(counts, dim=-1).to(labels.dtype)
        lab_all.append(torch.where(ok & (n_unique > 1), majority, labels[rows, i]))
        keep.append(torch.where(ok, i, -1))
        ok_all.append(ok)
        drop = ok[:, None] & (newly | (col[None, :] == i[:, None]))
        alive = torch.where(drop, float("-inf"), alive)
    keep_idx = torch.stack(keep, 1)
    valid = torch.stack(ok_all, 1)
    idx_c = keep_idx.clamp(min=0)
    out_boxes = torch.where(valid[..., None], gather_rows(boxes, idx_c), 0.0)
    out_scores = torch.where(valid, torch.gather(scores, 1, idx_c), 0.0)
    out_labels = torch.where(valid, torch.stack(lab_all, 1), -1)
    return out_boxes, out_scores, out_labels, valid


def nms_majority(boxes: torch.Tensor, scores: torch.Tensor,
                 class_ids: torch.Tensor, num_classes: int,
                 iou_threshold: float = 0.6, max_output: int = 100,
                 valid: torch.Tensor | None = None, method: str = "fixedpoint"):
    """Majority-vote NMS over a batch.

    Class-agnostic greedy NMS (suppress IoU > threshold) in which each kept
    box takes the majority class of the boxes it suppresses when those hold
    more than one distinct class; count ties go to the smallest class id.

    boxes [B, N, 4] xyxy, scores [B, N], class_ids [B, N], valid [B, N] or
    None. Returns (boxes [B, K, 4], scores [B, K], labels [B, K] int32,
    valid [B, K]) with K = max_output, padded with zeros / -1 / False.
    """
    s = scores if valid is None else torch.where(valid, scores, float("-inf"))
    labels = class_ids.to(torch.int32)
    if method == "fixedpoint":
        return _majority_nms_fixedpoint(boxes, s, labels, num_classes,
                                        iou_threshold, max_output)
    if method == "scan":
        return _majority_nms_scan(boxes, s, labels, num_classes, iou_threshold,
                                  max_output)
    raise ValueError(f"unknown nms_majority method {method!r}")


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               max_output: int, valid: torch.Tensor | None = None):
    """Greedy NMS per group: boxes [G, N, 4] xyxy, scores [G, N] (-inf or
    ``valid`` False marks a dead box) -> (keep_idx [G, K] int32 in greedy
    order, padded with -1; valid [G, K]), K = max_output. The contract of
    the JAX ``nms_pallas`` / ``_select_max_nms`` with a group dimension."""
    if boxes.is_cuda:
        return nms_kernel.greedy_nms_cuda(boxes, scores, iou_threshold, max_output, valid)
    if boxes.device.type != "cpu":
        raise ValueError(f"no greedy NMS for device {boxes.device}")
    return nms_kernel.greedy_nms_reference(boxes, scores, iou_threshold, max_output,
                                           valid)


def fixedpoint_keep(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_threshold: float, valid: torch.Tensor | None = None) -> torch.Tensor:
    """The greedy kept set as a mask [G, N] in input order (the JAX
    ``_fixedpoint_keep``, whose fixed point is this set); ``valid`` False
    marks a dead box, as a score of -inf or NaN does."""
    g, n = scores.shape
    keep, ok = greedy_nms(boxes, scores, iou_threshold, n, valid)
    slots = torch.where(ok, keep, n).long()  # padding goes to a spare column
    kept = torch.zeros((g, n + 1), dtype=torch.bool, device=scores.device)
    return kept.scatter_(1, slots, True)[:, :n]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_output: int = 100, valid: torch.Tensor | None = None):
    """Greedy NMS with a fixed output size over a batch: boxes [B, N, 4],
    scores [B, N], valid [B, N] or None. Suppresses IoU strictly above the
    threshold. Returns (boxes [B, K, 4], scores [B, K], keep_idx [B, K]
    padded with -1, valid [B, K]) in score order."""
    s = scores if valid is None else torch.where(valid, scores, float("-inf"))
    keep_idx, out_valid = greedy_nms(boxes, s, iou_threshold, max_output)
    idx_c = keep_idx.clamp(min=0).long()
    out_boxes = torch.where(out_valid[..., None], gather_rows(boxes, idx_c), 0.0)
    out_scores = torch.where(out_valid, torch.gather(s, 1, idx_c), 0.0)
    return out_boxes, out_scores, keep_idx, out_valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor,
                iou_threshold: float = 0.5, max_output: int = 100,
                valid: torch.Tensor | None = None):
    """Class-aware NMS through the coordinate offset class * (max_coord + 1)
    (torchvision batched_nms): boxes of different classes never overlap.
    Returns (boxes, scores, labels, keep_idx, valid), labels -1 where not
    valid."""
    masked = boxes if valid is None else torch.where(valid[..., None], boxes, 0.0)
    max_coord = masked.amax(dim=(1, 2))
    offsets = class_ids.to(boxes.dtype)[..., None] * (max_coord[:, None, None] + 1.0)
    _, out_scores, keep_idx, out_valid = nms(boxes + offsets, scores, iou_threshold,
                                             max_output, valid)
    idx_c = keep_idx.clamp(min=0).long()
    out_boxes = torch.where(out_valid[..., None], gather_rows(boxes, idx_c), 0.0)
    out_labels = torch.where(out_valid, torch.gather(class_ids, 1, idx_c), -1)
    return out_boxes, out_scores, out_labels, keep_idx, out_valid
