"""Detection evaluator orchestration (port of the JAX package's
``eval/evaluator.py``): the CocoEvaluator equivalent.

* ``update`` turns one batch of padded detections into COCO result dicts
  (xyxy -> xywh, rescale to the original image size, label remap such as
  COCO 80 -> 91). It takes tensors (a pipeline's outputs, on any device)
  or numpy arrays and copies each argument to the host once a batch;
* ``synchronize_between_processes`` merges the result lists of all ranks
  with a pad-gather (lengths first, then the padded JSON bytes) through
  ``torch.distributed.all_gather``, each image's results from the first
  rank that has any (a sharded set that does not split evenly repeats its
  first images on the last ranks); a no-op in one process;
* ``summarize`` runs the numpy COCOeval and returns the 12 stats;
  ``save_detections`` dumps the standard JSON.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from object_detectors_tpu_torch.eval import coco_map

# COCO 80-class contiguous -> 91-id mapping (the reference ships this as
# coco_files/coco_80_91.json; derived from the standard category list).
COCO_80_TO_91 = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40,
    41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79,
    80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
]


def _host(x, dtype=None) -> np.ndarray:
    """A tensor (copied to the host once; bf16 widened to f32) or an array
    as a numpy array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.cpu().numpy()
    return np.asarray(x, dtype)


class DetectionEvaluator:
    def __init__(self, gt: dict,
                 label_map: Callable[[int], int] | None = None):
        """gt: COCO dict. label_map: contiguous model label -> dataset
        category id (e.g. ``lambda c: COCO_80_TO_91[c]`` for COCO-80
        models, ``lambda c: c + 1`` for LVIS 0-based)."""
        self.gt = gt
        self.label_map = label_map or (lambda c: c)
        self.results: list[dict] = []
        self._img_hw = {im["id"]: (im["height"], im["width"])
                        for im in gt["images"]}

    def update(self, image_ids, boxes, scores, labels, valid,
               scale_factors=None, masks=None, keypoints=None):
        """Add one batch of padded detections.

        image_ids: [B] ints; boxes [B, D, 4] xyxy in model input coords;
        scores/labels/valid [B, D]; scale_factors: optional [B, 2]
        (sx, sy) multipliers back to original image coordinates.
        masks: optional [B, D, m, m] probability maps (Mask R-CNN), pasted
        into the ORIGINAL image canvas, thresholded at 0.5 and
        RLE-encoded. keypoints: optional [B, D, K, 3] (x, y, vis) in model
        input coords, rescaled and stored flattened.
        """
        boxes = _host(boxes, np.float64)
        scores = _host(scores, np.float64)
        labels = _host(labels)
        valid = _host(valid, bool)
        image_ids = _host(image_ids)
        if scale_factors is not None:
            scale_factors = _host(scale_factors)
        if masks is not None:
            from object_detectors_tpu_torch.data import masks as mask_lib
            from object_detectors_tpu_torch.eval import native

            masks = _host(masks, np.float32)
        if keypoints is not None:
            keypoints = _host(keypoints, np.float64)
        for b, img_id in enumerate(image_ids.tolist()):
            bx = boxes[b]
            sx = sy = 1.0
            if scale_factors is not None:
                sx, sy = scale_factors[b]
                bx = bx * np.array([sx, sy, sx, sy])
            for d in range(bx.shape[0]):
                if not valid[b, d]:
                    continue
                x1, y1, x2, y2 = bx[d]
                res = {
                    "image_id": int(img_id),
                    "category_id": int(self.label_map(int(labels[b, d]))),
                    "bbox": [float(x1), float(y1),
                             float(x2 - x1), float(y2 - y1)],
                    "score": float(scores[b, d]),
                }
                if keypoints is not None:
                    kp = keypoints[b, d].copy()
                    kp[:, 0] *= sx
                    kp[:, 1] *= sy
                    res["keypoints"] = kp.reshape(-1).tolist()
                if masks is not None:
                    h0, w0 = self._img_hw[int(img_id)]
                    pasted = mask_lib.paste_mask(masks[b, d], bx[d],
                                                 h0, w0)
                    rle = native.rle_encode(
                        (pasted > 0.5).astype(np.uint8))
                    res["segmentation"] = rle
                    # segm area-range binning must use the MASK area
                    # (pycocotools loadRes: area = maskUtils.area(rle))
                    res["area"] = float(native.rle_area(rle))
                self.results.append(res)

    def synchronize_between_processes(self, _allgather=None):
        """Gather the result lists of all ranks. A no-op unless
        ``torch.distributed`` is initialized with more than one rank.
        ``_allgather`` (numpy [n] -> numpy [world, n]) is injectable so the
        pad-gather merge is testable in one process."""
        if _allgather is None:
            if not (torch.distributed.is_available()
                    and torch.distributed.is_initialized()
                    and torch.distributed.get_world_size() > 1):
                return
            _allgather = _torch_allgather

        payload = json.dumps(self.results, default=_jsonable)
        arr = np.frombuffer(payload.encode(), dtype=np.uint8)
        # pad-gather: lengths first, then bytes
        n = np.array([arr.size], np.int32)
        all_n = _allgather(n)
        maxn = int(all_n.max())
        padded = np.zeros(maxn, np.uint8)
        padded[: arr.size] = arr
        gathered = _allgather(padded)
        merged, seen = [], set()
        for i, ln in enumerate(np.asarray(all_n).reshape(-1).tolist()):
            chunk = json.loads(bytes(np.asarray(gathered)[i][:ln]).decode())
            # data/coco.py:shard_indices pads the last ranks with the first
            # images: score each image once, as the earliest rank saw it
            merged.extend(r for r in chunk if r["image_id"] not in seen)
            seen.update(r["image_id"] for r in chunk)
        self.results = merged

    def summarize(self, iou_type: str = "bbox"):
        ev = coco_map.COCOEvalNP(self.gt, self.results, iou_type=iou_type)
        ev.evaluate_and_accumulate()
        return ev.summarize()

    def per_category_ap(self, iou_type: str = "bbox"):
        ev = coco_map.COCOEvalNP(self.gt, self.results, iou_type=iou_type)
        ev.evaluate_and_accumulate()
        return ev.per_category_ap()

    def save_detections(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.results, f, default=_jsonable)


def _torch_allgather(x: np.ndarray) -> np.ndarray:
    """[n] on every rank -> [world, n]: ``torch.distributed.all_gather`` of
    one equal-length tensor a rank (on the current CUDA device under NCCL,
    on the CPU otherwise)."""
    dist = torch.distributed
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def _jsonable(obj):
    """JSON fallback for numpy payloads (RLE counts arrays etc.)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"not JSON serializable: {type(obj)}")
