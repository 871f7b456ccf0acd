"""Experiment comparison tools (copied from the JAX package's
``analysis/compare.py``; numpy and scipy).

* :func:`per_category_table` — the `notebooks/get_map.py` role: evaluate
  several result JSONs against one GT and tabulate per-category AP side
  by side (sorted by frequency like the notebook's idf join).
* :func:`mcnemar_disagreement` — the `notebooks/get_disagreement.py`
  role: for two models' detections, build the per-GT hit/miss
  contingency table (matched at IoU>=0.5, score-descending greedy) and
  run McNemar's test (exact binomial for small discordant counts,
  chi-square with continuity correction otherwise — statsmodels isn't in
  the image, so the test statistic is computed directly).
"""

from __future__ import annotations

import json

import numpy as np
from scipy import stats

from object_detectors_tpu_torch.eval import coco_map


def _load(dts):
    if isinstance(dts, str):
        with open(dts) as f:
            return json.load(f)
    return dts


def per_category_table(gt: dict, result_sets: dict, sort_by_freq=True):
    """result_sets: {experiment_name: detections list or json path}.

    Returns (rows, columns): rows = list of dicts {category_id, name,
    instance_count, <experiment>: AP}.
    """
    cats = {c["id"]: c.get("name", str(c["id"]))
            for c in gt["categories"]}
    counts = {cid: 0 for cid in cats}
    for a in gt["annotations"]:
        counts[a["category_id"]] = counts.get(a["category_id"], 0) + 1

    per_exp = {}
    for name, dts in result_sets.items():
        ev = coco_map.COCOEvalNP(gt, _load(dts)).evaluate_and_accumulate()
        per_exp[name] = ev.per_category_ap()

    rows = []
    for cid in cats:
        row = {"category_id": cid, "name": cats[cid],
               "instances": counts.get(cid, 0)}
        for name in result_sets:
            row[name] = per_exp[name].get(cid, -1.0)
        rows.append(row)
    if sort_by_freq:
        rows.sort(key=lambda r: -r["instances"])
    return rows


def _match_hits(gt: dict, dts: list, iou_thr: float = 0.5,
                score_thr: float = 0.0):
    """Per-GT-annotation binary hit vector under greedy IoU matching."""
    by_img_cat_gt = {}
    order_gt = []
    for a in gt["annotations"]:
        key = (a["image_id"], a["category_id"])
        by_img_cat_gt.setdefault(key, []).append(a)
        order_gt.append(a["id"])
    by_img_cat_dt = {}
    for d in _load(dts):
        if d["score"] >= score_thr:
            key = (d["image_id"], d["category_id"])
            by_img_cat_dt.setdefault(key, []).append(d)

    hits = {}
    for key, gts in by_img_cat_gt.items():
        dets = sorted(by_img_cat_dt.get(key, []),
                      key=lambda d: -d["score"])
        gt_boxes = np.array([g["bbox"] for g in gts], np.float64)
        matched = np.zeros(len(gts), bool)
        if dets:
            dt_boxes = np.array([d["bbox"] for d in dets], np.float64)
            iou = coco_map.box_iou_xywh(
                dt_boxes, gt_boxes, np.zeros(len(gts)))
            for di in range(len(dets)):
                cand = np.where(~matched & (iou[di] >= iou_thr))[0]
                if cand.size:
                    matched[cand[np.argmax(iou[di][cand])]] = True
        for g, m in zip(gts, matched):
            hits[g["id"]] = bool(m)
    return np.array([hits.get(gid, False) for gid in order_gt])


def mcnemar_disagreement(gt: dict, dts_a, dts_b, iou_thr: float = 0.5,
                         score_thr: float = 0.1):
    """Returns dict with the 2x2 contingency table over GT objects
    (hit-by-A x hit-by-B), the McNemar statistic and p-value."""
    ha = _match_hits(gt, dts_a, iou_thr, score_thr)
    hb = _match_hits(gt, dts_b, iou_thr, score_thr)
    n11 = int(np.sum(ha & hb))
    n10 = int(np.sum(ha & ~hb))
    n01 = int(np.sum(~ha & hb))
    n00 = int(np.sum(~ha & ~hb))

    n_disc = n10 + n01
    if n_disc == 0:
        stat, p = 0.0, 1.0
    elif n_disc < 25:
        # exact binomial test (statsmodels exact=True equivalent)
        p = float(stats.binomtest(min(n10, n01), n_disc, 0.5).pvalue)
        stat = float(min(n10, n01))
    else:
        stat = (abs(n10 - n01) - 1) ** 2 / n_disc
        p = float(stats.chi2.sf(stat, df=1))
    return {"table": [[n11, n10], [n01, n00]],
            "statistic": stat, "pvalue": p,
            "recall_a": (n11 + n10) / max(len(ha), 1),
            "recall_b": (n11 + n01) / max(len(ha), 1)}


def kmeans_anchors(gt: dict, num_anchors: int = 9, img_size: int = 416,
                   iters: int = 100, seed: int = 0):
    """Anchor-prior estimation (`yolo/utilities/kmeans_anchors.py:1-63`):
    k-means over normalized (w, h) box shapes, scaled to pixel anchors,
    sorted by area descending and grouped 3-per-scale like the config
    layout. Plain numpy Lloyd's algorithm (sklearn-free)."""
    wh = []
    by_img = {im["id"]: (im["width"], im["height"])
              for im in gt["images"]}
    for a in gt["annotations"]:
        w, h = by_img[a["image_id"]]
        wh.append([a["bbox"][2] / w, a["bbox"][3] / h])
    wh = np.asarray(wh, np.float64)
    rng = np.random.RandomState(seed)
    centers = wh[rng.choice(len(wh), num_anchors, replace=False)]
    for _ in range(iters):
        d = ((wh[:, None, :] - centers[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        new = np.array([
            wh[assign == k].mean(0) if (assign == k).any() else centers[k]
            for k in range(num_anchors)])
        if np.allclose(new, centers, atol=1e-9):
            break
        centers = new
    anchors = np.round(centers * img_size).astype(int)
    order = np.argsort(-(anchors[:, 0] * anchors[:, 1]))
    anchors = anchors[order]
    per_scale = max(num_anchors // 3, 1)
    return [anchors[i * per_scale:(i + 1) * per_scale].tolist()
            for i in range(3)]
