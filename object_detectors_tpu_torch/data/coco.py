"""COCO / LVIS / drones dataset loading + padded batch pipeline (port of the
JAX package's ``data/coco.py``; cv2 and Pillow are imported only by the
functions that decode or downscale an image).

Parity with `yolo/dsets/{coco_dataset,lvis_dataset,drones_dataset}.py` and
`torchvision_models/detection/coco_utils.py`:
* items are (image, target{bbox xywh abs, category_id, area, image_id});
  images without annotations are skipped (the reference returns None and
  filters in collate, coco_dataset.py:60-63);
* ``subset`` randomly subsamples the image list (coco_dataset.py:30-34);
* label modes: COCO 91->80 contiguous (COCO91_80), LVIS 1-based -> 0
  (Class1_0), or raw ids;
* the DistributedSampler + ragged collate
  (`procedures/init_dataset.py:82-101`) becomes: shard the index list by
  process, emit fixed-shape padded batches, with a background prefetch
  thread standing in for DataLoader workers.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Callable, Iterator

import numpy as np

from object_detectors_tpu_torch.data import transforms as T


class CocoDetectionDataset:
    """COCO-format detection dataset (file-backed or in-memory dict)."""

    def __init__(
        self,
        annotations: str | dict,
        images_dir: str | None = None,
        label_mode: str = "coco80",   # coco80 | lvis0 | raw
        subset: float = 1.0,
        rng: np.random.RandomState | None = None,
        image_loader: Callable[[dict], np.ndarray] | None = None,
    ):
        if isinstance(annotations, str):
            with open(annotations) as f:
                annotations = json.load(f)
        self.gt = annotations
        self.images_dir = images_dir
        self.label_mode = label_mode
        self.image_loader = image_loader
        self._images = {im["id"]: im for im in annotations["images"]}
        self._anns_by_image: dict[int, list] = {}
        for ann in annotations["annotations"]:
            if ann.get("iscrowd", 0):
                continue
            self._anns_by_image.setdefault(ann["image_id"], []).append(ann)
        # keep only images WITH annotations (reference filters Nones)
        self.ids = [i for i in sorted(self._images)
                    if self._anns_by_image.get(i)]
        if subset < 1.0:
            rng = rng or np.random.RandomState(0)
            keep = max(1, int(len(self.ids) * subset))
            self.ids = sorted(
                rng.choice(self.ids, keep, replace=False).tolist())

    def __len__(self):
        return len(self.ids)

    def map_label(self, category_id: int) -> int:
        if self.label_mode == "coco80":
            return T.COCO_91_TO_80.get(category_id, 0)
        if self.label_mode == "lvis0":
            return category_id - 1
        return category_id

    def load_image(self, info: dict) -> np.ndarray:
        if self.image_loader is not None:
            return self.image_loader(info)
        path = os.path.join(self.images_dir or "", info["file_name"])
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 2:  # gray -> RGB (coco_dataset.py:57-59)
            img = np.stack([img] * 3, -1)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __getitem__(self, idx: int):
        img_id = self.ids[idx]
        info = self._images[img_id]
        image = self.load_image(info)
        anns = self._anns_by_image[img_id]
        boxes = np.array([a["bbox"] for a in anns], np.float32)
        labels = np.array([self.map_label(a["category_id"]) for a in anns],
                          np.int32)
        target = {
            "boxes_xywh": boxes,
            "labels": labels,
            "image_id": img_id,
            "orig_size": (info["height"], info["width"]),
        }
        # keypoint annotations (coco_kp / get_coco_kp parity); anns
        # missing the field get all-invisible keypoints
        if anns and "keypoints" in anns[0]:
            k = len(anns[0]["keypoints"]) // 3
            target["keypoints"] = np.array(
                [np.asarray(a.get("keypoints", [0.0] * (3 * k)),
                            np.float32).reshape(-1, 3) for a in anns])
        return image, target


def shard_indices(n: int, process_index: int, process_count: int,
                  shuffle: bool, seed: int) -> np.ndarray:
    """DistributedSampler semantics: pad to a multiple of world size,
    round-robin shard."""
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    pad = (-n) % process_count
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[process_index::process_count]


def yolo_batches(
    dataset: CocoDetectionDataset,
    batch_size: int,
    inp_dim: int,
    max_boxes: int = 100,
    shuffle: bool = False,
    seed: int = 0,
    augment_rng: np.random.RandomState | None = None,
    process_index: int = 0,
    process_count: int = 1,
    prefetch: int = 2,
) -> Iterator[dict]:
    """Padded YOLO batches: images [B,S,S,3] normalized, gt_boxes rel
    cxcywh, labels, valid, image_id, scale back-factors."""
    order = shard_indices(len(dataset), process_index, process_count,
                          shuffle, seed)

    def produce(i0):
        imgs, bxs, lbs, vds, ids, scales = [], [], [], [], [], []
        for idx in order[i0:i0 + batch_size]:
            image, tgt = dataset[int(idx)]
            boxes, labels = tgt["boxes_xywh"], tgt["labels"]
            if augment_rng is not None:
                xyxy = boxes.copy()
                xyxy[:, 2:] += xyxy[:, :2]
                image, xyxy, labels = T.yolo_augment(
                    augment_rng, image, xyxy, labels)
                boxes = xyxy.copy()
                boxes[:, 2:] -= boxes[:, :2]
            img, rel = T.resize_to_tensor(image, boxes, inp_dim)
            b, l, v = T.pad_targets(rel, labels, max_boxes)
            imgs.append(img)
            bxs.append(b)
            lbs.append(l)
            vds.append(v)
            ids.append(tgt["image_id"])
            h, w = tgt["orig_size"]
            scales.append((w / inp_dim, h / inp_dim))
        # repeat last item to fill static batch
        while len(imgs) < batch_size:
            imgs.append(imgs[-1])
            bxs.append(bxs[-1])
            lbs.append(lbs[-1])
            vds.append(np.zeros_like(vds[-1]))
            ids.append(-1)
            scales.append(scales[-1])
        return {
            "images": np.stack(imgs),
            "gt_boxes": np.stack(bxs),
            "gt_labels": np.stack(lbs),
            "gt_valid": np.stack(vds),
            "image_ids": np.array(ids, np.int64),
            "scale_factors": np.array(scales, np.float32),
        }

    yield from _prefetched(
        produce, range(0, len(order), batch_size), prefetch)


def yolo_batches_uint8(
    dataset: CocoDetectionDataset,
    batch_size: int,
    inp_dim: int,
    canvas_size: int = 640,
    max_boxes: int = 100,
    shuffle: bool = False,
    seed: int = 0,
    augment_rng: np.random.RandomState | None = None,
    process_index: int = 0,
    process_count: int = 1,
    prefetch: int = 2,
) -> Iterator[dict]:
    """Device-ingest batches: the host only DECODES — each raw uint8
    image is placed top-left at native resolution in a fixed
    [canvas_size]^2 canvas; the square bicubic resize + normalize run on
    device (kernels/preprocess.resize_normalize_from_canvas), per the
    BASELINE.json north star (host cv2 resize was the reference's path,
    transformations.py:29). Images larger than the canvas are
    host-downscaled to fit (rare on COCO val at 640).

    ``augment_rng`` enables the train-path augment family (same
    semantics as :func:`yolo_batches` — the geometric/photometric
    augments run on the native-resolution uint8 image BEFORE canvas
    placement; only the resize+normalize moves on device).

    Yields dicts like :func:`yolo_batches` but with uint8 ``images``
    [B, C, C, 3], extra ``sizes`` [B, 2] (h, w) true sizes, and the
    same relative GT / scale_factors contract (GT never needs pixels).
    The device resize is ``kernels/preprocess.resize_normalize_from_canvas``
    of this package.
    """
    order = shard_indices(len(dataset), process_index, process_count,
                          shuffle, seed)
    cs = canvas_size

    def produce(i0):
        imgs, szs, bxs, lbs, vds, ids, scales = [], [], [], [], [], [], []
        for idx in order[i0:i0 + batch_size]:
            image, tgt = dataset[int(idx)]
            boxes = tgt["boxes_xywh"].astype(np.float32)
            labels = tgt["labels"]
            if augment_rng is not None:
                xyxy = boxes.copy()
                if xyxy.size:
                    xyxy[:, 2:] += xyxy[:, :2]
                image, xyxy, labels = T.yolo_augment(
                    augment_rng, image, xyxy, labels)
                boxes = xyxy.copy()
                if boxes.size:
                    boxes[:, 2:] -= boxes[:, :2]
                ih, iw = image.shape[:2]
            else:
                ih, iw = tgt["orig_size"]
            h, w = image.shape[:2]
            if h > cs or w > cs:  # host fallback downscale to fit
                from PIL import Image

                r = min(cs / h, cs / w)
                nh, nw = max(int(h * r), 1), max(int(w * r), 1)
                image = np.asarray(Image.fromarray(image).resize(
                    (nw, nh), Image.BICUBIC))
                h, w = nh, nw
            canvas = np.zeros((cs, cs, 3), np.uint8)
            canvas[:h, :w] = image
            oh, ow = tgt["orig_size"]
            if boxes.size:
                cx = (boxes[:, 0] + boxes[:, 2] / 2) / iw
                cy = (boxes[:, 1] + boxes[:, 3] / 2) / ih
                rel = np.stack([cx, cy, boxes[:, 2] / iw,
                                boxes[:, 3] / ih], 1)
            else:
                rel = np.zeros((0, 4), np.float32)
            b, l, v = T.pad_targets(rel, labels, max_boxes)
            imgs.append(canvas)
            szs.append((h, w))
            bxs.append(b)
            lbs.append(l)
            vds.append(v)
            ids.append(tgt["image_id"])
            scales.append((ow / inp_dim, oh / inp_dim))
        while len(imgs) < batch_size:
            imgs.append(imgs[-1])
            szs.append(szs[-1])
            bxs.append(bxs[-1])
            lbs.append(lbs[-1])
            vds.append(np.zeros_like(vds[-1]))
            ids.append(-1)
            scales.append(scales[-1])
        return {
            "images": np.stack(imgs),
            "sizes": np.array(szs, np.int32),
            "gt_boxes": np.stack(bxs),
            "gt_labels": np.stack(lbs),
            "gt_valid": np.stack(vds),
            "image_ids": np.array(ids, np.int64),
            "scale_factors": np.array(scales, np.float32),
        }

    yield from _prefetched(
        produce, range(0, len(order), batch_size), prefetch)


def _prefetched(fn, starts, depth):
    """Background-thread prefetch (DataLoader-worker stand-in). Worker
    exceptions re-raise in the consumer — a swallowed error would
    silently truncate the epoch.

    Close-aware: if the consumer abandons iteration (break / exception /
    GC of the generator), the worker is cancelled and joined instead of
    blocking forever in ``q.put`` on the bounded queue (the round-2
    SIGABRT: leaked workers accumulated across a pytest process)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()
    cancel = threading.Event()
    err: list[BaseException] = []

    def worker():
        try:
            for s in starts:
                if cancel.is_set():
                    return
                item = fn(s)
                while True:
                    if cancel.is_set():
                        return
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — propagate to consumer
            err.append(e)
        finally:
            # stop must reach a live consumer even through a full queue;
            # a cancelled consumer no longer needs it.
            while not cancel.is_set():
                try:
                    q.put(stop, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if err:
                    raise err[0]
                break
            yield item
    finally:
        cancel.set()
        # Drain so a put blocked on a full queue observes cancel quickly,
        # then join; a worker mid-fn() finishes its batch and exits.
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10.0)
