"""LVIS-protocol evaluation (port of the JAX package's ``eval/lvis_map.py``;
the lvis-api LVISEval role,
`yolo/procedures/eval_results.py:60-67` / `detection/coco_eval.py`).

Differences from the COCO protocol implemented here:
* a single maxDets = 300;
* federated annotations: for image i and category c, detections are
  ignored (neither TP nor FP) unless c is in the image's positive
  categories or its ``neg_category_ids`` — and GT-less (i, c) cells with
  c in ``not_exhaustive_category_ids`` are likewise skipped;
* summary adds APr / APc / APf over the rare (<10 imgs) / common
  (10-100) / frequent (>100) category groups (the category
  ``image_count`` or ``frequency`` field).
"""

from __future__ import annotations

import numpy as np

from object_detectors_tpu_torch.eval import coco_map as C

LVIS_MAX_DETS = 300


class LVISEvalNP(C.COCOEvalNP):
    def __init__(self, gt: dict, dt: list, plain: bool = False):
        super().__init__(gt, dt, plain=plain)
        self._img_pos: dict[int, set] = {}
        for ann in gt["annotations"]:
            self._img_pos.setdefault(ann["image_id"], set()).add(
                ann["category_id"])
        self._img_neg = {im["id"]: set(im.get("neg_category_ids", []))
                         for im in gt["images"]}
        self._img_ne = {
            im["id"]: set(im.get("not_exhaustive_category_ids", []))
            for im in gt["images"]}
        # category frequency groups
        img_count = {}
        for cat in gt["categories"]:
            cid = cat["id"]
            cnt = cat.get("image_count")
            if cnt is None:
                cnt = len({a["image_id"] for a in gt["annotations"]
                           if a["category_id"] == cid})
            img_count[cid] = cnt
        self.freq_group = {
            cid: ("r" if n < 10 else "c" if n <= 100 else "f")
            for cid, n in img_count.items()}

    def evaluate_and_accumulate(self):
        t, r = len(C.IOU_THRS), len(C.REC_THRS)
        k, a = len(self.cat_ids), len(C.AREA_RNG)
        precision = -np.ones((t, r, k, a, 1))
        recall = -np.ones((t, k, a, 1))

        for ki, cat in enumerate(self.cat_ids):
            for ai, (aname, arng) in enumerate(C.AREA_RNG.items()):
                per_img = []
                for img in self.img_ids:
                    gts = self._gts.get((img, cat), [])
                    dts = self._dts.get((img, cat), [])
                    if not gts:
                        # federated: only count FPs on images where the
                        # category is known absent (neg) — otherwise
                        # this (img, cat) cell is not evaluated.
                        if cat not in self._img_neg.get(img, set()):
                            continue
                    elif cat in self._img_ne.get(img, set()):
                        # annotations not exhaustive: detections beyond
                        # the matched ones must not count as FPs; the
                        # standard implementation still evaluates the
                        # cell but flags dts matched to nothing as
                        # ignored. We approximate by evaluating normally
                        # (matched dts count) and ignoring unmatched.
                        pass
                    if not gts and not dts:
                        continue
                    dm, dig, gig, sc = C._evaluate_img(
                        dts, gts, arng, LVIS_MAX_DETS, plain=self.plain)
                    if gts and cat in self._img_ne.get(img, set()):
                        dig = dig | (dm == 0)
                    per_img.append((dm, dig, gig, sc))
                if not per_img:
                    continue
                dtm = np.concatenate([p[0] for p in per_img], axis=1)
                dtig = np.concatenate([p[1] for p in per_img], axis=1)
                gtig = np.concatenate([p[2] for p in per_img])
                scores = np.concatenate([p[3] for p in per_img])
                npig = int((~gtig).sum())
                if npig == 0:
                    continue
                order = np.argsort(-scores, kind="mergesort")
                dtm_s, dtig_s = dtm[:, order], dtig[:, order]
                tps = (dtm_s > 0) & (~dtig_s)
                fps = (dtm_s == 0) & (~dtig_s)
                tp_sum = np.cumsum(tps, 1).astype(np.float64)
                fp_sum = np.cumsum(fps, 1).astype(np.float64)
                for ti in range(t):
                    tp, fp = tp_sum[ti], fp_sum[ti]
                    nd = len(tp)
                    rc = tp / npig
                    pr = (tp / np.maximum(tp + fp, np.spacing(1))).tolist()
                    recall[ti, ki, ai, 0] = rc[-1] if nd else 0
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    q = np.zeros(r)
                    inds = np.searchsorted(rc, C.REC_THRS, side="left")
                    for ri, pi in enumerate(inds):
                        if pi < nd:
                            q[ri] = pr[pi]
                    precision[ti, :, ki, ai, 0] = q
        self.eval = {"precision": precision, "recall": recall}
        return self

    def _group_ap(self, group: str | None):
        p = self.eval["precision"][:, :, :, 0, 0]
        vals = []
        for ki, cid in enumerate(self.cat_ids):
            if group and self.freq_group.get(cid) != group:
                continue
            v = p[:, :, ki]
            v = v[v > -1]
            if v.size:
                vals.append(v.mean())
        return float(np.mean(vals)) if vals else -1.0

    def summarize(self):
        """[AP, AP50, AP75, APs, APm, APl, APr, APc, APf] — lvis-api
        ordering; stats[0] is the selection metric."""
        pr = self.eval["precision"]

        def ap(iou_thr=None, area="all"):
            ai = list(C.AREA_RNG).index(area)
            s = pr[:, :, :, ai, 0]
            if iou_thr is not None:
                ti = int(np.where(np.isclose(C.IOU_THRS, iou_thr))[0][0])
                s = s[ti:ti + 1]
            valid = s[s > -1]
            return float(valid.mean()) if valid.size else -1.0

        return np.array([
            ap(), ap(0.5), ap(0.75), ap(area="small"),
            ap(area="medium"), ap(area="large"),
            self._group_ap("r"), self._group_ap("c"), self._group_ap("f"),
        ])
