"""Synthetic COCO-format detection data (copied from the JAX package's
``data/synthetic.py``).

Serves the role the reference has no answer for (it has no tests and
needs real COCO on disk, SURVEY.md §4): a deterministic in-memory dataset
of random images + boxes in both padded-tensor form (for train/bench) and
COCO-dict form (for hermetic evaluator tests).
"""

from __future__ import annotations

import numpy as np


def make_batch(
    rng: np.random.RandomState,
    batch_size: int,
    img_size: int,
    max_boxes: int = 20,
    num_classes: int = 80,
):
    """Random padded batch: images NHWC f32, gt (rel cxcywh), labels, valid."""
    images = rng.rand(batch_size, img_size, img_size, 3).astype(np.float32)
    n_boxes = rng.randint(1, max_boxes + 1, size=batch_size)
    boxes = np.zeros((batch_size, max_boxes, 4), np.float32)
    labels = np.zeros((batch_size, max_boxes), np.int32)
    valid = np.zeros((batch_size, max_boxes), bool)
    for b in range(batch_size):
        n = n_boxes[b]
        cx = rng.uniform(0.1, 0.9, n)
        cy = rng.uniform(0.1, 0.9, n)
        w = rng.uniform(0.05, 0.4, n)
        h = rng.uniform(0.05, 0.4, n)
        w = np.minimum(w, 2 * np.minimum(cx, 1 - cx))
        h = np.minimum(h, 2 * np.minimum(cy, 1 - cy))
        boxes[b, :n] = np.stack([cx, cy, w, h], -1)
        labels[b, :n] = rng.randint(0, num_classes, n)
        valid[b, :n] = True
    return {
        "images": images,
        "gt_boxes": boxes,
        "gt_labels": labels,
        "gt_valid": valid,
    }


def make_coco_dicts(
    rng: np.random.RandomState,
    num_images: int,
    img_size: int = 128,
    num_classes: int = 5,
    max_boxes: int = 6,
    with_segmentation: bool = False,
    with_keypoints: bool = False,
    num_keypoints: int = 17,
):
    """COCO-format (images, annotations, categories) dicts for hermetic
    evaluator tests — boxes in absolute [x, y, w, h]; optionally with
    rectangular polygon segmentations matching the boxes (and the
    rectangles render_image draws), enabling segm-mode eval tests."""
    images, annotations = [], []
    ann_id = 1
    for i in range(1, num_images + 1):
        images.append({"id": i, "width": img_size, "height": img_size,
                       "file_name": f"synthetic_{i}.jpg"})
        for _ in range(rng.randint(1, max_boxes + 1)):
            w = rng.uniform(8, img_size * 0.5)
            h = rng.uniform(8, img_size * 0.5)
            x = rng.uniform(0, img_size - w)
            y = rng.uniform(0, img_size - h)
            ann = {
                "id": ann_id,
                "image_id": i,
                "category_id": int(rng.randint(1, num_classes + 1)),
                "bbox": [float(x), float(y), float(w), float(h)],
                "area": float(w * h),
                "iscrowd": 0,
            }
            if with_segmentation:
                ann["segmentation"] = [[
                    float(x), float(y), float(x + w), float(y),
                    float(x + w), float(y + h), float(x), float(y + h)]]
            if with_keypoints:
                kx = rng.uniform(x, x + w, num_keypoints)
                ky = rng.uniform(y, y + h, num_keypoints)
                kp = np.stack([kx, ky, np.full(num_keypoints, 2.0)], 1)
                ann["keypoints"] = kp.reshape(-1).tolist()
                ann["num_keypoints"] = num_keypoints
            annotations.append(ann)
            ann_id += 1
    categories = [{"id": c, "name": f"class_{c}"}
                  for c in range(1, num_classes + 1)]
    return {"images": images, "annotations": annotations,
            "categories": categories}


CLASS_COLORS = np.array([
    [220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40],
    [220, 40, 220], [40, 220, 220], [120, 200, 80], [200, 120, 80],
], np.uint8)


def render_image(gt: dict, image_id: int, noise_seed: int = 0):
    """Render a LEARNABLE image for a synthetic COCO dict: gray noise
    background + filled class-colored rectangles at each annotation box.
    This gives train/eval pipelines real pixel<->box signal (pure-noise
    images make mAP unlearnable)."""
    info = next(im for im in gt["images"] if im["id"] == image_id)
    h, w = info["height"], info["width"]
    rng = np.random.RandomState(noise_seed + image_id)
    img = rng.randint(90, 160, (h, w, 3)).astype(np.uint8)
    for a in gt["annotations"]:
        if a["image_id"] != image_id:
            continue
        x, y, bw, bh = [int(round(v)) for v in a["bbox"]]
        color = CLASS_COLORS[(a["category_id"] - 1) % len(CLASS_COLORS)]
        img[max(y, 0):min(y + bh, h), max(x, 0):min(x + bw, w)] = color
    return img


def renderable_dataset(rng, num_images=16, img_size=96, num_classes=4,
                       max_boxes=4):
    """(gt_dict, image_loader) pair with learnable images."""
    gt = make_coco_dicts(rng, num_images, img_size, num_classes,
                         max_boxes)
    return gt, lambda info: render_image(gt, info["id"])
