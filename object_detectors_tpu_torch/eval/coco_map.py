"""COCO-style mAP evaluation in numpy (port of the JAX package's
``eval/coco_map.py``).

The per-cell greedy matcher runs in the native core
(``csrc/coco_eval_core.cpp`` through ``eval/native.py``); the Python loop of
the JAX package's fallback is its plain version, taken only with
``plain=True`` (the tests hold the two against each other).

The reference delegates to pycocotools' COCOeval C-accelerated loops
(`yolo/procedures/eval_results.py:1-3`, `detection/coco_eval.py:10-12`);
that package is not available here, so this module reimplements the
COCOeval bbox protocol (matching semantics, area ranges, 101-point
interpolated AP, the 12 summary stats) hermetically. Verified against the
published algorithm spec; matching follows the original greedy rules:

* detections processed in score-descending order; each may match one
  unmatched GT with IoU >= threshold, preferring highest IoU; crowd GTs
  can be matched repeatedly and matches to them are ignored;
* GTs outside the area range are "ignored" — matching them doesn't count
  either way; unmatched detections outside the range are ignored too;
* precision envelope + interpolation at 101 recall points.

Also provides the LVIS AP variant (per-image category exhaustiveness is
approximated by the standard protocol — LVIS' not-exhaustive flags need
the dataset's neg/not_exhaustive lists, supplied via ``img_nel`` when
available).
"""

from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)

# keypoints protocol (pycocotools COCOeval.setKpParams / coco_eval.py:
# 142-166): areas all/medium/large only, maxDets 20, OKS sigmas
KP_AREA_RNG = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
KP_MAX_DETS = (20,)
KP_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
    1.07, 1.07, .87, .87, .89, .89]) / 10.0


def compute_oks(dt_kps: np.ndarray, gts: list,
                sigmas: np.ndarray | None = None) -> np.ndarray:
    """OKS matrix [D, G] (pycocotools computeOks): per-gt gaussian
    distance over labeled keypoints, normalized by gt area; gts with no
    labeled keypoints fall back to a box-proximity window."""
    d, g = len(dt_kps), len(gts)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    k = dt_kps.shape[1]
    if sigmas is None:
        sigmas = KP_SIGMAS if k == 17 else np.full(k, 0.05)
    var = (sigmas * 2.0) ** 2
    out = np.zeros((d, g))
    for j, gt in enumerate(gts):
        gkp = np.asarray(gt["keypoints"], np.float64).reshape(-1, 3)
        xg, yg, vg = gkp[:, 0], gkp[:, 1], gkp[:, 2]
        k1 = int((vg > 0).sum())
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + 2 * bb[2]
        y0, y1 = bb[1] - bb[3], bb[1] + 2 * bb[3]
        area = gt.get("area", bb[2] * bb[3])
        for i in range(d):
            xd, yd = dt_kps[i][:, 0], dt_kps[i][:, 1]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:  # gt unlabeled: distance to the inflated box
                dx = np.maximum(x0 - xd, 0) + np.maximum(xd - x1, 0)
                dy = np.maximum(y0 - yd, 0) + np.maximum(yd - y1, 0)
            e = (dx**2 + dy**2) / var / (area + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return out


def box_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                 iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix [D, G] for xywh boxes; crowd GT uses union = det area
    (pycocotools maskUtils.iou semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), d_area,
                     d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _evaluate_img(dts, gts, area_rng, max_det, iou_fn=None, plain=False):
    """Match one (image, category) cell.

    dts: list of dicts {bbox (xywh), score}; gts: {bbox, area, iscrowd}.
    iou_fn: optional (sorted_dts, sorted_gts) -> [D, G] matrix override
    (used by segm mode); default is bbox IoU. ``plain``: the Python matcher
    loop instead of the native one.
    Returns (dt_matches [T, D], dt_ignore [T, D], gt_ignore [G],
    dt_scores [D]) with T=len(IOU_THRS).
    """
    t = len(IOU_THRS)
    # segm mode (signalled by an iou_fn override) bins detections by MASK
    # area; bbox mode by bbox w*h — results may carry both fields
    segm_mode = iou_fn is not None
    gt_ignore = np.array(
        [bool(g.get("iscrowd", 0)) or bool(g.get("ignore", 0)) or not
         (area_rng[0] <= g["area"] <= area_rng[1]) for g in gts],
        dtype=bool)
    # sort gts: non-ignored first (pycocotools gtind ordering)
    gt_order = np.argsort(gt_ignore, kind="stable")
    gts = [gts[i] for i in gt_order]
    gt_ignore = gt_ignore[gt_order]

    dt_scores = np.array([d["score"] for d in dts])
    dt_order = np.argsort(-dt_scores, kind="stable")[:max_det]
    dts = [dts[i] for i in dt_order]
    dt_scores = dt_scores[dt_order]

    d, g = len(dts), len(gts)
    dt_m = np.zeros((t, d), dtype=np.int64)  # 0 unmatched, else gt id+1
    gt_m = np.zeros((t, g), dtype=np.int64)
    dt_ig = np.zeros((t, d), dtype=bool)

    if d and g:
        if iou_fn is not None:
            iou = iou_fn(dts, gts)
        else:
            iou = box_iou_xywh(
                np.array([dd["bbox"] for dd in dts], np.float64),
                np.array([gg["bbox"] for gg in gts], np.float64),
                np.array([gg.get("iscrowd", 0) for gg in gts]))
        iscrowd = np.array([int(gg.get("iscrowd", 0)) for gg in gts])
        if not plain:
            from object_detectors_tpu_torch.eval import native

            dt_m, dt_ig = native.evaluate_img_native(
                iou, gt_ignore, iscrowd, IOU_THRS)
            d_areas = np.array([_det_area(dd, segm_mode) for dd in dts])
            out_rng = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
            dt_ig = dt_ig | ((dt_m == 0) & out_rng[None, :])
            return dt_m, dt_ig, gt_ignore, dt_scores
        for ti, thr in enumerate(IOU_THRS):
            for di in range(d):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(g):
                    # gt already matched (and not crowd) -> skip
                    if gt_m[ti, gi] > 0 and not iscrowd[gi]:
                        continue
                    # moving to ignored gt after a non-ignored match: stop
                    if best_g > -1 and not gt_ignore[best_g] \
                            and gt_ignore[gi]:
                        break
                    if iou[di, gi] < best_iou:
                        continue
                    best_iou = iou[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                dt_ig[ti, di] = gt_ignore[best_g]
                dt_m[ti, di] = best_g + 1
                gt_m[ti, best_g] = di + 1

    # unmatched dets outside the area range are ignored
    d_areas = np.array([_det_area(dd, segm_mode) for dd in dts]) \
        if d else np.zeros(0)
    out_of_rng = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
    dt_ig = dt_ig | ((dt_m == 0) & out_of_rng[None, :])
    return dt_m, dt_ig, gt_ignore, dt_scores


def _kp_iou_fn(dts, gts):
    """OKS override for _evaluate_img (keypoints mode)."""
    dt_kps = np.stack([
        np.asarray(d["keypoints"], np.float64).reshape(-1, 3)
        for d in dts]) if dts else np.zeros((0, 17, 3))
    return compute_oks(dt_kps, gts)


def _det_area(dd, segm_mode: bool) -> float:
    """Detection area for area-range binning: segm eval uses the mask
    area (pycocotools loadRes sets area=maskUtils.area for segm
    results), bbox eval uses bbox w*h."""
    if segm_mode and dd.get("area") is not None:
        return float(dd["area"])
    return dd["bbox"][2] * dd["bbox"][3]


class COCOEvalNP:
    """Minimal COCOeval-protocol evaluator.

    gt: COCO dict {images, annotations, categories}.
    dt: list of detection dicts {image_id, category_id, bbox (xywh),
    score} (the format of `detection/coco_eval.py:83-105` /
    `yolo/procedures/test_one_epoch.py:41-66`).
    plain: the Python matcher loop and the numpy RLE routines instead of
    the native core.
    """

    def __init__(self, gt: dict, dt: list, iou_type: str = "bbox",
                 plain: bool = False):
        if iou_type not in ("bbox", "segm", "keypoints"):
            raise ValueError(f"unknown iou_type {iou_type!r}")
        self.iou_type = iou_type
        self.plain = plain
        # keypoints protocol: areas all/medium/large, maxDets 20
        self.area_rng = KP_AREA_RNG if iou_type == "keypoints" \
            else AREA_RNG
        self.max_dets = KP_MAX_DETS if iou_type == "keypoints" \
            else MAX_DETS
        self._img_hw = {im["id"]: (im["height"], im["width"])
                        for im in gt["images"]}
        self.cat_ids = sorted(c["id"] for c in gt["categories"])
        self.img_ids = sorted(im["id"] for im in gt["images"])
        self._gts = {}
        for ann in gt["annotations"]:
            a = dict(ann)
            a.setdefault("area", a["bbox"][2] * a["bbox"][3])
            if iou_type == "keypoints":
                # pycocotools: gts without labeled keypoints are ignored
                nk = a.get("num_keypoints")
                if nk is None:
                    kp = np.asarray(a.get("keypoints", []),
                                    np.float64).reshape(-1, 3)
                    nk = int((kp[:, 2] > 0).sum()) if kp.size else 0
                a["ignore"] = bool(a.get("ignore", 0)) or nk == 0
            self._gts.setdefault(
                (ann["image_id"], ann["category_id"]), []).append(a)
        self._dts = {}
        for det in dt:
            self._dts.setdefault(
                (det["image_id"], det["category_id"]), []).append(det)
        self.eval = None

    def evaluate_and_accumulate(self):
        t, r = len(IOU_THRS), len(REC_THRS)
        k = len(self.cat_ids)
        a, m = len(self.area_rng), len(self.max_dets)
        precision = -np.ones((t, r, k, a, m))
        recall = -np.ones((t, k, a, m))

        for ki, cat in enumerate(self.cat_ids):
            for ai, (aname, arng) in enumerate(self.area_rng.items()):
                # evaluate every image at the largest maxDet, then slice
                per_img = []
                for img in self.img_ids:
                    gts = self._gts.get((img, cat), [])
                    dts = self._dts.get((img, cat), [])
                    if not gts and not dts:
                        continue
                    if self.iou_type == "segm":
                        iou_fn = self._segm_iou_fn(img)
                    elif self.iou_type == "keypoints":
                        iou_fn = _kp_iou_fn
                    else:
                        iou_fn = None
                    per_img.append(_evaluate_img(
                        dts, gts, arng, self.max_dets[-1], iou_fn,
                        self.plain))
                if not per_img:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    dtm = np.concatenate(
                        [p[0][:, :max_det] for p in per_img], axis=1)
                    dtig = np.concatenate(
                        [p[1][:, :max_det] for p in per_img], axis=1)
                    gtig = np.concatenate([p[2] for p in per_img])
                    scores = np.concatenate(
                        [p[3][:max_det] for p in per_img])
                    npig = int((~gtig).sum())
                    if npig == 0:
                        continue
                    order = np.argsort(-scores, kind="mergesort")
                    dtm_s = dtm[:, order]
                    dtig_s = dtig[:, order]
                    tps = (dtm_s > 0) & (~dtig_s)
                    fps = (dtm_s == 0) & (~dtig_s)
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(t):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(fp + tp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0
                        # precision envelope (monotone from the right)
                        q = np.zeros(r)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q
        self.eval = {"precision": precision, "recall": recall}
        return self

    def _summarize(self, ap=True, iou_thr=None, area="all",
                   max_det=None):
        ai = list(self.area_rng).index(area)
        mi = self.max_dets.index(max_det if max_det is not None
                                 else self.max_dets[-1])
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou_thr))[0][0])
                s = s[ti:ti + 1]
            s = s[:, :, :, ai, mi]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou_thr))[0][0])
                s = s[ti:ti + 1]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    # summarize() slices precision[..., 0, last] for "all" area, which in
    # keypoints mode indexes KP_AREA_RNG/KP_MAX_DETS consistently.

    def _segm_iou_fn(self, img_id):
        """RLE-based mask IoU for segm evaluation (native core)."""
        from object_detectors_tpu_torch.data import masks as mask_lib
        from object_detectors_tpu_torch.eval import native

        h, w = self._img_hw[img_id]
        plain = self.plain

        def to_rle(obj):
            segm = obj.get("segmentation")
            if segm is None:  # fall back to the box as a mask
                x, y, bw, bh = obj["bbox"]
                m = np.zeros((h, w), np.uint8)
                m[int(y):int(y + bh), int(x):int(x + bw)] = 1
                return native.rle_encode(m, plain=plain)
            if isinstance(segm, dict) and not isinstance(
                    segm.get("counts"), str):
                return {"size": segm["size"],
                        "counts": np.asarray(segm["counts"], np.uint32)}
            m = mask_lib.segmentation_to_mask(segm, h, w, plain=plain)
            return native.rle_encode(m, plain=plain)

        def iou_fn(dts, gts):
            d_rles = [to_rle(d) for d in dts]
            g_rles = [to_rle(g) for g in gts]
            out = np.zeros((len(dts), len(gts)))
            for j, (g, gg) in enumerate(zip(g_rles, gts)):
                crowd = bool(gg.get("iscrowd", 0))
                for i, dr in enumerate(d_rles):
                    # crowd gt: union = det area -> pass gt as 'a' crowd
                    out[i, j] = native.rle_iou(g, dr, a_crowd=crowd,
                                               plain=plain)
            return out

        return iou_fn

    def summarize(self):
        """The 12 COCO stats (10 for keypoints); stats[0] is the
        model-selection metric (eval_results.py:57)."""
        s = self._summarize
        if self.iou_type == "keypoints":
            # pycocotools kpts protocol: AP/AP50/AP75/APm/APl then the
            # AR mirror, all at maxDets=20
            stats = [
                s(True), s(True, 0.5), s(True, 0.75),
                s(True, area="medium"), s(True, area="large"),
                s(False), s(False, 0.5), s(False, 0.75),
                s(False, area="medium"), s(False, area="large"),
            ]
            return np.array(stats)
        stats = [
            s(True), s(True, 0.5), s(True, 0.75),
            s(True, area="small"), s(True, area="medium"),
            s(True, area="large"),
            s(False, max_det=1), s(False, max_det=10), s(False),
            s(False, area="small"), s(False, area="medium"),
            s(False, area="large"),
        ]
        return np.array(stats)

    def per_category_ap(self):
        """AP@[.5:.95] per category (the get_map.py notebook metric)."""
        p = self.eval["precision"][:, :, :, 0, len(self.max_dets) - 1]
        out = {}
        for ki, cat in enumerate(self.cat_ids):
            v = p[:, :, ki]
            v = v[v > -1]
            out[cat] = float(np.mean(v)) if v.size else -1.0
        return out


def evaluate_detections(gt: dict, detections: list,
                        plain: bool = False) -> np.ndarray:
    """One-call helper: COCO dicts + detection list -> 12 stats."""
    ev = COCOEvalNP(gt, detections, plain=plain).evaluate_and_accumulate()
    return ev.summarize()
