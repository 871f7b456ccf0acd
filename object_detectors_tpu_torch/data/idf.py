"""Inverse document frequencies (the part of the JAX package's
``data/idf.py`` that the YOLO criterion and the R-CNN training loss reach):
the minibatch idf and the EQ loss's rarity mask. The dataset tables wait
for the data slice."""

from __future__ import annotations

import numpy as np
import torch

from object_detectors_tpu_torch.ops.losses import one_hot


def minibatch_idf(gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """Padded labels [B, M] and validity [B, M] -> [num_classes] f32 weights
    log((B + 1) / (present + 1)) + 1, ``present`` the images holding a class."""
    b = gt_labels.shape[0]
    onehot = one_hot(gt_labels, num_classes) * gt_valid[..., None].float()
    present = (onehot.sum(1) > 0).float()  # [B, C]
    df = present.sum(0)
    return torch.log((b + 1) / (df + 1)) + 1.0


def eq_rare_mask(img_freq: np.ndarray, threshold: float = 0.0045) -> np.ndarray:
    """EQ-loss rarity mask: 1.0 where a class's share of the image
    frequencies is below ``threshold``."""
    freq = img_freq / img_freq.sum()
    return (freq < threshold).astype(np.float32)
