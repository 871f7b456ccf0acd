"""Segmentation mask plumbing (port of the JAX package's ``data/masks.py``)
— the `detection/coco_utils.py:50-108`
(ConvertCocoPolysToMask) role plus RLE utilities.

* polygon rasterization in pure numpy (matplotlib-free scanline fill;
  pycocotools' frPyObjects is a C extension we don't have);
* crowd RLE decoding via the native core (eval/native.py);
* degenerate-box filtering identical to the reference.
"""

from __future__ import annotations

import numpy as np


def rasterize_polygon(poly_xy: np.ndarray, h: int, w: int) -> np.ndarray:
    """[N, 2] polygon (x, y) -> [h, w] uint8 mask via even-odd scanline
    fill (COCO polygon semantics)."""
    mask = np.zeros((h, w), np.uint8)
    xs = np.asarray(poly_xy[:, 0], np.float64)
    ys = np.asarray(poly_xy[:, 1], np.float64)
    n = len(xs)
    if n < 3:
        return mask
    for row in range(h):
        yc = row + 0.5
        nodes = []
        j = n - 1
        for i in range(n):
            if (ys[i] < yc) != (ys[j] < yc):
                x_at = xs[i] + (yc - ys[i]) / (ys[j] - ys[i]) * \
                    (xs[j] - xs[i])
                nodes.append(x_at)
            j = i
        nodes.sort()
        for k in range(0, len(nodes) - 1, 2):
            x0 = max(int(np.ceil(nodes[k] - 0.5)), 0)
            x1 = min(int(np.floor(nodes[k + 1] - 0.5)) + 1, w)
            if x1 > x0:
                mask[row, x0:x1] = 1
    return mask


def segmentation_to_mask(segm, h: int, w: int, plain: bool = False) -> np.ndarray:
    """COCO 'segmentation' field (list of polygons OR RLE dict) ->
    [h, w] uint8 mask. ``plain``: decode an RLE with the numpy version
    instead of the native core."""
    if isinstance(segm, dict):  # RLE (crowd annotations)
        from object_detectors_tpu_torch.eval import native

        counts = segm["counts"]
        if isinstance(counts, str):
            counts = _decode_compressed_rle(counts, h, w)
        return native.rle_decode({"size": [h, w],
                                  "counts": np.asarray(counts,
                                                       np.uint32)},
                                 plain=plain)
    mask = np.zeros((h, w), np.uint8)
    for poly in segm:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        mask |= rasterize_polygon(pts, h, w)
    return mask


def _decode_compressed_rle(counts_str: str, h: int, w: int):
    """pycocotools compressed-RLE string -> uncompressed counts
    (the LEB128-style varint scheme of maskApi.c rleFrString)."""
    counts = []
    p = 0
    m = 0
    s = counts_str.encode() if isinstance(counts_str, str) else counts_str
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if m > 2:
            x += counts[m - 2]
        counts.append(x)
        m += 1
    return counts


def filter_degenerate(boxes_xyxy: np.ndarray):
    """Keep-mask for boxes with x2 > x1 and y2 > y1
    (coco_utils.py:95-100)."""
    return (boxes_xyxy[:, 2] > boxes_xyxy[:, 0]) & \
        (boxes_xyxy[:, 3] > boxes_xyxy[:, 1])


def masks_for_annotations(anns, h: int, w: int) -> np.ndarray:
    """[N, h, w] float32 masks for a list of annotations."""
    if not anns:
        return np.zeros((0, h, w), np.float32)
    return np.stack([
        segmentation_to_mask(a["segmentation"], h, w).astype(np.float32)
        for a in anns])


def paste_mask(mask: np.ndarray, box_xyxy, h: int, w: int,
               padding: int = 1) -> np.ndarray:
    """Host-side paste of one fixed-resolution mask prob map into an
    [h, w] canvas — torchvision `paste_mask_in_image` semantics
    (roi_heads.py:415-536): pad by 1, expand the box by the matching
    scale, truncate-to-int box, bilinear resize to (bh, bw) with the
    +1 TO_REMOVE convention, paste clipped.

    Used to rescale predicted masks back to the ORIGINAL image size for
    segm evaluation (`tvision/transform.py:228-240` postprocess), where
    per-image sizes vary so a static-shape device op doesn't fit.
    """
    import cv2

    m = mask.shape[0]
    mp = m + 2 * padding
    padded = np.zeros((mp, mp), np.float32)
    padded[padding:padding + m, padding:padding + m] = mask
    scale = mp / m
    cx = (box_xyxy[0] + box_xyxy[2]) * 0.5
    cy = (box_xyxy[1] + box_xyxy[3]) * 0.5
    hw = (box_xyxy[2] - box_xyxy[0]) * 0.5 * scale
    hh = (box_xyxy[3] - box_xyxy[1]) * 0.5 * scale
    ib = np.array([cx - hw, cy - hh, cx + hw, cy + hh]).astype(np.int64)
    bw = max(int(ib[2] - ib[0] + 1), 1)
    bh = max(int(ib[3] - ib[1] + 1), 1)
    resized = cv2.resize(padded, (bw, bh), interpolation=cv2.INTER_LINEAR)
    out = np.zeros((h, w), np.float32)
    x0, y0 = max(int(ib[0]), 0), max(int(ib[1]), 0)
    x1, y1 = min(int(ib[2]) + 1, w), min(int(ib[3]) + 1, h)
    if x1 > x0 and y1 > y0:
        out[y0:y1, x0:x1] = resized[y0 - int(ib[1]):y1 - int(ib[1]),
                                    x0 - int(ib[0]):x1 - int(ib[0])]
    return out
