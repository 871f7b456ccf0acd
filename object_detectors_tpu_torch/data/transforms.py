"""Host-side (numpy/cv2) image + box transforms.

Parity targets:
* `yolo/dsets/transformations.py`: ResizeToTensor (cv2 INTER_CUBIC square
  resize -> /255 -> ImageNet mean/std normalize -> boxes to *relative
  cxcywh*), COCO91_80 (91 category ids -> 80 contiguous), Class1_0 (LVIS
  1-based -> 0-based), Augment (random photometric/geometric augs with
  retry-until-a-box-survives semantics, :96-194 — rebuilt on cv2/numpy
  since imgaug isn't available).
* `torchvision_models/tvision/transform.py`: GeneralizedRCNNTransform's
  normalize + min/max-size resize + pad-to-divisible batching — made
  static-shape by resolution bucketing (SURVEY.md §7 "Variable input
  sizes").
* `detection/transforms.py`: hflip, RandomIoUCrop, RandomZoomOut,
  RandomPhotometricDistort (the SSD augmentation policy).

All functions are numpy on the host (port of the JAX package's
``data/transforms.py``): the device program starts at the padded batch.

cv2 (or Pillow, where the JAX package falls back to it) is imported inside
the functions that resize or warp, not with the module. A resize to the
image's own size returns the image unchanged without importing either:
both libraries return such an image pixel for pixel. A resize to another
size with neither library raises; the blur and the affine augment, as in
the JAX package, leave the image alone without cv2.
"""

from __future__ import annotations

import numpy as np

from object_detectors_tpu_torch.eval.evaluator import COCO_80_TO_91
from object_detectors_tpu_torch.kernels.preprocess import IMAGENET_MEAN, IMAGENET_STD

# COCO 91 -> 80 contiguous (inverse of evaluator.COCO_80_TO_91)

COCO_91_TO_80 = {cid: i for i, cid in enumerate(COCO_80_TO_91)}


def _cv2():
    """The cv2 module, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _resize(image: np.ndarray, size_wh: tuple, cv2_interp: str, pil_filter: str,
            pil_input=None) -> np.ndarray:
    """``cv2.resize(image, size_wh, interpolation=cv2.<cv2_interp>)``, or
    Pillow's ``resize(size_wh, Image.<pil_filter>)`` of ``pil_input`` (the
    image by default) where cv2 is missing; the image itself when it already
    has that size. Raises where a resize is needed and neither imports."""
    if (image.shape[1], image.shape[0]) == tuple(size_wh):
        return image
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(image, size_wh, interpolation=getattr(cv2, cv2_interp))
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("resizing an image needs cv2 (opencv-python) or Pillow; "
                           "neither is installed") from None
    src = image if pil_input is None else pil_input
    return np.asarray(Image.fromarray(src).resize(size_wh, getattr(Image, pil_filter)))


def resize_to_tensor(image: np.ndarray, boxes_xywh: np.ndarray,
                     inp_dim: int):
    """ResizeToTensor semantics (transformations.py:10-53): square resize
    (INTER_CUBIC), scale to [0,1], ImageNet-normalize, boxes (absolute
    COCO xywh) -> relative cxcywh.

    Returns (image [inp,inp,3] float32 NHWC, boxes_rel_cxcywh [N,4]).
    """
    h, w = image.shape[:2]
    img = _resize(image, (inp_dim, inp_dim), "INTER_CUBIC", "BICUBIC")
    img = img.astype(np.float32) / 255.0
    img = (img - IMAGENET_MEAN) / IMAGENET_STD

    if boxes_xywh.size:
        b = boxes_xywh.astype(np.float32)
        cx = (b[:, 0] + b[:, 2] / 2) / w
        cy = (b[:, 1] + b[:, 3] / 2) / h
        bw = b[:, 2] / w
        bh = b[:, 3] / h
        boxes = np.stack([cx, cy, bw, bh], 1)
    else:
        boxes = np.zeros((0, 4), np.float32)
    return img, boxes


def normalize_image(image: np.ndarray):
    """GeneralizedRCNNTransform normalize (transform.py:129-138)."""
    img = image.astype(np.float32)
    if img.max() > 2.0:
        img = img / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def min_max_resize_factor(h: int, w: int, min_size: int = 800,
                          max_size: int = 1333) -> float:
    """GeneralizedRCNNTransform resize rule (transform.py:150-173)."""
    scale = min_size / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    return scale


def rcnn_resize(image: np.ndarray, boxes_xyxy: np.ndarray,
                min_size: int = 800, max_size: int = 1333,
                size_divisible: int = 32, pad_to: tuple | None = None):
    """Resize keeping aspect ratio then pad bottom/right to a static
    bucket (pad_to) or the next /32 (transform.py:208-226).

    Returns (padded image, scaled boxes xyxy, (new_h, new_w) true size,
    scale factor)."""
    h, w = image.shape[:2]
    scale = min_max_resize_factor(h, w, min_size, max_size)
    if pad_to is not None:
        # the static canvas is a hard bound (augmentations like
        # RandomZoomOut can blow up one dimension past max_size/ar)
        scale = min(scale, pad_to[0] / h, pad_to[1] / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    img = _resize(image, (nw, nh), "INTER_LINEAR", "BILINEAR",
                  pil_input=image.astype(np.uint8))
    if pad_to is None:
        ph = (nh + size_divisible - 1) // size_divisible * size_divisible
        pw = (nw + size_divisible - 1) // size_divisible * size_divisible
    else:
        ph, pw = pad_to
    out = np.zeros((ph, pw) + image.shape[2:], img.dtype)
    out[:nh, :nw] = img
    boxes = boxes_xyxy.astype(np.float32) * scale if boxes_xyxy.size \
        else np.zeros((0, 4), np.float32)
    return out, boxes, (nh, nw), scale


def hflip(image: np.ndarray, boxes_xyxy: np.ndarray):
    """RandomHorizontalFlip body (detection/transforms.py:19-45)."""
    w = image.shape[1]
    img = image[:, ::-1]
    if boxes_xyxy.size:
        b = boxes_xyxy.copy()
        b[:, [0, 2]] = w - boxes_xyxy[:, [2, 0]]
    else:
        b = boxes_xyxy
    return np.ascontiguousarray(img), b


# COCO person-keypoint L/R channel swap under horizontal flip
# (detection/transforms.py:10-17 _flip_coco_person_keypoints)
COCO_PERSON_KEYPOINT_FLIP_INDS = (
    0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


def hflip_keypoints(keypoints: np.ndarray, width: int,
                    flip_inds=COCO_PERSON_KEYPOINT_FLIP_INDS):
    """[N, K, 3] (x, y, vis) keypoints under a horizontal flip: swap the
    left/right channels, mirror x, zero invisible rows (the COCO
    vis==0 -> x=y=0 convention)."""
    kp = keypoints[:, list(flip_inds)].copy()
    kp[..., 0] = width - kp[..., 0]
    kp[kp[..., 2] == 0] = 0
    return kp


# --- YOLO 'Augment' pipeline (transformations.py:96-194) rebuilt --------

def _aug_contrast(rng, img):
    gamma = rng.uniform(0.5, 2.0)
    f = np.clip(img.astype(np.float32) / 255.0, 0, 1) ** gamma
    return (f * 255).astype(img.dtype)


def _aug_grayscale(rng, img):
    g = img.mean(axis=2, keepdims=True)
    alpha = rng.uniform(0.0, 1.0)
    return (alpha * g + (1 - alpha) * img).astype(img.dtype)


def _aug_blur(rng, img):
    cv2 = _cv2()
    if cv2 is None:
        return img
    k = int(rng.choice([3, 5]))
    return cv2.GaussianBlur(img, (k, k), 0)


def _aug_noise(rng, img):
    noise = rng.normal(0, rng.uniform(2, 12), img.shape)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(img.dtype)


def _aug_dropout(rng, img):
    mask = rng.rand(*img.shape[:2]) < rng.uniform(0.0, 0.05)
    out = img.copy()
    out[mask] = 0
    return out


def _aug_cutout(rng, img):
    h, w = img.shape[:2]
    out = img.copy()
    for _ in range(rng.randint(1, 3)):
        ch, cw = int(h * 0.1), int(w * 0.1)
        y = rng.randint(0, max(h - ch, 1))
        x = rng.randint(0, max(w - cw, 1))
        out[y:y + ch, x:x + cw] = rng.randint(0, 255)
    return out


def _aug_affine(rng, img, boxes):
    """Scale + translate, dropping boxes that leave the frame."""
    h, w = img.shape[:2]
    scale = rng.uniform(0.8, 1.2)
    tx = rng.uniform(-0.1, 0.1) * w
    ty = rng.uniform(-0.1, 0.1) * h
    cv2 = _cv2()
    if cv2 is None:
        return img, boxes, np.ones(len(boxes), bool)
    mat = np.array([[scale, 0, tx], [0, scale, ty]], np.float32)
    out = cv2.warpAffine(img, mat, (w, h))
    if boxes.size:
        b = boxes.copy().astype(np.float32)
        b[:, [0, 2]] = b[:, [0, 2]] * scale + tx
        b[:, [1, 3]] = b[:, [1, 3]] * scale + ty
        clipped = b.copy()
        clipped[:, [0, 2]] = np.clip(b[:, [0, 2]], 0, w)
        clipped[:, [1, 3]] = np.clip(b[:, [1, 3]], 0, h)
        survives = ((clipped[:, 2] - clipped[:, 0]) > 2) & \
                   ((clipped[:, 3] - clipped[:, 1]) > 2)
        return out, clipped, survives
    return out, boxes, np.ones(0, bool)


def yolo_augment(rng: np.random.RandomState, image: np.ndarray,
                 boxes_xyxy: np.ndarray, labels: np.ndarray,
                 max_tries: int = 10):
    """One-of photometric/geometric augmentation with the reference's
    retry-until-a-box-survives loop (transformations.py:96-194).

    image: uint8 HWC. boxes absolute xyxy. Returns (image, boxes, labels).
    """
    photometric = [_aug_contrast, _aug_grayscale, _aug_blur, _aug_noise,
                   _aug_dropout, _aug_cutout]
    for _ in range(max_tries):
        choice = rng.randint(0, len(photometric) + 2)
        if choice < len(photometric):
            return photometric[choice](rng, image), boxes_xyxy, labels
        if choice == len(photometric):
            img, b = hflip(image, boxes_xyxy)
            return img, b, labels
        img, b, survives = _aug_affine(rng, image, boxes_xyxy)
        if survives.any() or len(boxes_xyxy) == 0:
            return img, b[survives], labels[survives]
        # no box survived: retry another augmentation
    return image, boxes_xyxy, labels


# --- SSD augmentations (detection/transforms.py:54-239) -----------------

def random_iou_crop(rng, image, boxes_xyxy, labels,
                    min_scale=0.3, max_scale=1.0, trials=40):
    """SSD-style sampled crop: keep boxes whose center lies inside."""
    h, w = image.shape[:2]
    if len(boxes_xyxy) == 0:
        return image, boxes_xyxy, labels
    for min_iou in [0.0, 0.1, 0.3, 0.5, 0.7, 0.9]:
        for _ in range(trials):
            s = rng.uniform(min_scale, max_scale)
            ar = rng.uniform(0.5, 2.0)
            nw = int(w * s * np.sqrt(ar))
            nh = int(h * s / np.sqrt(ar))
            if nw < 1 or nh < 1 or nw > w or nh > h:
                continue
            x0 = rng.randint(0, w - nw + 1)
            y0 = rng.randint(0, h - nh + 1)
            crop = np.array([x0, y0, x0 + nw, y0 + nh], np.float32)
            cx = (boxes_xyxy[:, 0] + boxes_xyxy[:, 2]) / 2
            cy = (boxes_xyxy[:, 1] + boxes_xyxy[:, 3]) / 2
            inside = (cx >= crop[0]) & (cx < crop[2]) & \
                     (cy >= crop[1]) & (cy < crop[3])
            if not inside.any():
                continue
            b = boxes_xyxy[inside].copy()
            iw = np.clip(np.minimum(b[:, 2], crop[2])
                         - np.maximum(b[:, 0], crop[0]), 0, None)
            ih = np.clip(np.minimum(b[:, 3], crop[3])
                         - np.maximum(b[:, 1], crop[1]), 0, None)
            area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            ious = iw * ih / np.maximum(area, 1e-9)
            if ious.min() < min_iou:
                continue
            img = image[y0:y0 + nh, x0:x0 + nw]
            b[:, [0, 2]] = np.clip(b[:, [0, 2]] - x0, 0, nw)
            b[:, [1, 3]] = np.clip(b[:, [1, 3]] - y0, 0, nh)
            return img, b, labels[inside]
    return image, boxes_xyxy, labels


def random_zoom_out(rng, image, boxes_xyxy, max_scale=4.0,
                    fill=(123, 117, 104)):
    """Canvas expansion (detection/transforms.py:132-189)."""
    h, w = image.shape[:2]
    s = rng.uniform(1.0, max_scale)
    nh, nw = int(h * s), int(w * s)
    y0 = rng.randint(0, nh - h + 1)
    x0 = rng.randint(0, nw - w + 1)
    canvas = np.ones((nh, nw, 3), image.dtype) * np.array(
        fill, image.dtype)
    canvas[y0:y0 + h, x0:x0 + w] = image
    b = boxes_xyxy.copy()
    if b.size:
        b[:, [0, 2]] += x0
        b[:, [1, 3]] += y0
    return canvas, b


def photometric_distort(rng, image):
    """Brightness/contrast/saturation/hue jitter
    (detection/transforms.py:190-239, simplified to numpy ops)."""
    img = image.astype(np.float32)
    if rng.rand() < 0.5:
        img += rng.uniform(-32, 32)
    if rng.rand() < 0.5:
        img *= rng.uniform(0.5, 1.5)
    if rng.rand() < 0.5:
        g = img.mean(axis=2, keepdims=True)
        img = g + (img - g) * rng.uniform(0.5, 1.5)
    return np.clip(img, 0, 255).astype(image.dtype)


def pad_targets(boxes: np.ndarray, labels: np.ndarray, max_boxes: int):
    """Ragged -> padded (boxes [M,4], labels [M], valid [M])."""
    n = min(len(boxes), max_boxes)
    out_b = np.zeros((max_boxes, 4), np.float32)
    out_l = np.zeros((max_boxes,), np.int32)
    out_v = np.zeros((max_boxes,), bool)
    if n:
        out_b[:n] = boxes[:n]
        out_l[:n] = labels[:n]
        out_v[:n] = True
    return out_b, out_l, out_v
