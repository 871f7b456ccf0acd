"""Aspect-ratio grouped batching (copied from the JAX package's
``data/grouping.py``).

Parity with `torchvision_models/detection/group_by_aspect_ratio.py`:
* images are binned by aspect ratio into 2*k+1 bins at
  2^linspace(-log2(k'), log2(k'), 2k+1) cut points (:196-211);
* batches are drawn from a single bin; incomplete trailing batches are
  topped up with already-seen samples from the same (or nearest) bin so
  every batch is full and same-shaped (:24-85) — which is exactly
  what static shapes want: one compiled program per bin resolution.
"""

from __future__ import annotations

import bisect

import numpy as np


def aspect_ratio_bins(k: int = 3):
    """2^linspace bin edges (create_aspect_ratio_groups)."""
    return (2.0 ** np.linspace(-np.log2(k), np.log2(k),
                               2 * k + 1)).tolist()


def group_ids(aspect_ratios, bins):
    """Quantize each AR into its bin index (0..len(bins))."""
    return np.array([bisect.bisect_right(bins, ar)
                     for ar in aspect_ratios])


def dataset_aspect_ratios(dataset):
    """w/h per item straight from annotation metadata (the fast path of
    group_by_aspect_ratio.py:88-190 — no image decode)."""
    out = []
    for img_id in dataset.ids:
        info = dataset._images[img_id]
        out.append(info["width"] / info["height"])
    return np.array(out)


def grouped_batch_indices(group_id_per_item, batch_size: int,
                          shuffle: bool = True, seed: int = 0):
    """Yield index lists of length batch_size, all from one group; the
    final partial batch of each group is topped up with repeats of
    already-seen samples from that group (GroupedBatchSampler:24-85)."""
    order = np.arange(len(group_id_per_item))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    buffers: dict[int, list] = {}
    seen: dict[int, list] = {}
    batches = []
    for idx in order:
        g = int(group_id_per_item[idx])
        buffers.setdefault(g, []).append(int(idx))
        seen.setdefault(g, []).append(int(idx))
        if len(buffers[g]) == batch_size:
            batches.append(buffers.pop(g))
    for g, buf in sorted(buffers.items()):
        if not buf:
            continue
        fill = seen[g]
        while len(buf) < batch_size:
            buf.append(fill[len(buf) % len(fill)])
        batches.append(buf)
    return batches
