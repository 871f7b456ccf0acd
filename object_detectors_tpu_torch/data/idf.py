"""tf-idf class-reweighting statistics (port of the JAX package's
``data/idf.py``, the IDFTransformer rebuild of `yolo/utilities/custom.py:163-262`).

* ``idf_tables``: from a COCO/LVIS-format annotation dict, per-class
  inverse-document-frequency weights over image-level document frequency
  (smooth, raw, prob, normit, gombit, base2, base10) and the same over
  instance counts (the ``*_obj`` family), plus ``img_freq`` and
  ``instance_freq``; classes without annotations are dropped. ``normit``
  takes ``scipy.special.ndtri``, as the JAX package does, so the tables are
  bitwise equal to its;
* ``save_idf_csv`` / ``load_idf_csv``: the tables as the CSV that pandas
  writes (a header of the public keys, one row per kept class, no index
  column, floats as ``repr``, NaN as an empty field), with the standard
  ``csv`` module: a file written by either package loads in the other;
* ``minibatch_idf`` (log((B+1)/(df_batch+1)) + 1 over a batch's per-image
  class presence, the global batch's above one process) and
  ``eq_rare_mask``.
"""

from __future__ import annotations

import csv
import math
import os

import numpy as np
import torch
from scipy.special import ndtri

from object_detectors_tpu_torch.ops.losses import one_hot
from object_detectors_tpu_torch.parallel import mesh

VARIANTS = ("smooth", "raw", "prob", "normit", "gombit", "base2", "base10")


def idf_tables(gt: dict) -> dict:
    """COCO/LVIS-format dict -> {variant: np.ndarray[num_kept_classes]}.

    Also returns 'img_freq', 'instance_freq', and '_kept_category_ids'
    (the surviving category ids in order).
    """
    cat_ids = sorted(c["id"] for c in gt["categories"])
    num_classes = cat_ids[-1] + 1  # reference: last_cat + 1 "for bg"
    per_image: dict[int, np.ndarray] = {}
    for ann in gt["annotations"]:
        row = per_image.setdefault(
            ann["image_id"], np.zeros(num_classes, np.int64))
        row[ann["category_id"]] += 1
    n_images = len(gt["images"])
    counts = np.zeros((n_images, num_classes), np.int64)
    for i, img in enumerate(gt["images"]):
        if img["id"] in per_image:
            counts[i] = per_image[img["id"]]

    mask = counts.sum(0) > 0
    kept_ids = np.nonzero(mask)[0]
    counts = counts[:, mask]

    doc_freq = (counts > 0).sum(0).astype(np.float64)
    instance_freq = counts.sum(0).astype(np.float64)
    n = float(counts.shape[0])

    out = {}
    p = doc_freq / n
    out["smooth"] = np.log((n + 1) / (doc_freq + 1)) + 1
    out["raw"] = np.log(n / doc_freq)
    out["prob"] = np.log((n - doc_freq) / doc_freq)
    out["normit"] = -ndtri(p)
    out["gombit"] = -np.log(-np.log(1 - p))
    out["base2"] = -np.log2(p)
    out["base10"] = -np.log10(p)

    big_n = instance_freq.sum()
    p_obj = instance_freq / big_n
    out["smooth_obj"] = np.log((big_n + 1) / (instance_freq + 1)) + 1
    out["raw_obj"] = np.log(big_n / instance_freq)
    out["prob_obj"] = np.log((big_n - instance_freq) / instance_freq)
    out["gombit_obj"] = -np.log(-np.log(1 - p_obj))
    out["normit_obj"] = -ndtri(p_obj)
    out["base2_obj"] = -np.log2(p_obj)
    out["base10_obj"] = -np.log10(p_obj)

    out["img_freq"] = doc_freq
    out["instance_freq"] = instance_freq
    out["_kept_category_ids"] = kept_ids
    return out


def save_idf_csv(tables: dict, path: str):
    """Write the tables' public columns as pandas' ``to_csv(index=False)``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = {k: np.asarray(v) for k, v in tables.items() if not k.startswith("_")}
    n = len(next(iter(cols.values())))
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for i in range(n):
            w.writerow(["" if math.isnan(float(v[i])) else repr(float(v[i]))
                        for v in cols.values()])


def load_idf_csv(path: str) -> dict:
    """{column: float64 array} of a table written by either package."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {k: np.array([float(r[i]) if r[i] else math.nan for r in body], np.float64)
            for i, k in enumerate(header)}


def minibatch_idf(gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                  num_classes: int) -> torch.Tensor:
    """Padded labels [B, M] and validity [B, M] -> [num_classes] f32 weights
    log((B + 1) / (present + 1)) + 1, ``present`` the images holding a class;
    above one process B and ``present`` count the global batch."""
    b = gt_labels.shape[0]
    onehot = one_hot(gt_labels, num_classes) * gt_valid[..., None].float()
    present = (onehot.sum(1) > 0).float()  # [B, C]
    df = present.sum(0)
    if mesh.process_count() > 1:
        counts = mesh.global_sum(torch.cat([df, df.new_tensor([b])]))
        df, b = counts[:-1], counts[-1]
    return torch.log((b + 1) / (df + 1)) + 1.0


def eq_rare_mask(img_freq: np.ndarray, threshold: float = 0.0045) -> np.ndarray:
    """EQ-loss rarity mask: 1.0 where a class's share of the image
    frequencies is below ``threshold``."""
    freq = img_freq / img_freq.sum()
    return (freq < threshold).astype(np.float32)
