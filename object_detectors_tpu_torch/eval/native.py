"""ctypes binding of the native COCO-eval core, ``csrc/coco_eval_core.cpp``
(port of the JAX package's ``eval/native.py``).

The library is built with g++ at first use by ``kernels/_build.py`` into the
package's git-ignored ``_build/`` and loaded once; a build or load failure
raises. The native matcher replaces the per-detection Python loop of
``eval/coco_map.py`` (the role of pycocotools' C-accelerated COCOeval).

Each RLE routine here also has its plain numpy version, the JAX package's
fallback, reached only by ``plain=True``; the tests hold the native code
against it, as a CUDA kernel is held against its plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import numpy as np

from object_detectors_tpu_torch.kernels._build import load_library


def load() -> ctypes.CDLL:
    """Build (once) and load the library, its signatures declared."""
    lib = load_library("coco_eval_core")
    if lib.rle_iou.argtypes is None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.bbox_iou_xywh.argtypes = [f64p, ctypes.c_int, f64p, ctypes.c_int, u8p, f64p]
        lib.bbox_iou_xywh.restype = None
        lib.evaluate_img.argtypes = [f64p, ctypes.c_int, ctypes.c_int, u8p, u8p, f64p,
                                     ctypes.c_int, i64p, u8p]
        lib.evaluate_img.restype = None
        lib.rle_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u32p]
        lib.rle_encode.restype = ctypes.c_int
        lib.rle_decode.argtypes = [u32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p]
        lib.rle_decode.restype = None
        lib.rle_area.argtypes = [u32p, ctypes.c_int]
        lib.rle_area.restype = ctypes.c_double
        lib.rle_iou.restype = ctypes.c_double
        lib.rle_iou.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int, ctypes.c_uint8]
    return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def evaluate_img_native(iou: np.ndarray, gt_ignore: np.ndarray,
                        gt_crowd: np.ndarray, thrs: np.ndarray):
    """iou [D, G] f64 -> (dt_match [T, D] int64, dt_ignore [T, D] bool)."""
    lib = load()
    d, g = iou.shape
    t = len(thrs)
    iou = np.ascontiguousarray(iou, np.float64)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    gc = np.ascontiguousarray(gt_crowd, np.uint8)
    th = np.ascontiguousarray(thrs, np.float64)
    dt_match = np.zeros((t, d), np.int64)
    dt_ignore = np.zeros((t, d), np.uint8)
    lib.evaluate_img(_ptr(iou, ctypes.c_double), d, g,
                     _ptr(gi, ctypes.c_uint8), _ptr(gc, ctypes.c_uint8),
                     _ptr(th, ctypes.c_double), t,
                     _ptr(dt_match, ctypes.c_int64),
                     _ptr(dt_ignore, ctypes.c_uint8))
    return dt_match, dt_ignore.astype(bool)


def rle_encode(mask: np.ndarray, plain: bool = False) -> dict:
    """Binary [H, W] mask -> {'size': [H, W], 'counts': uint32 array}
    (pycocotools uncompressed RLE, Fortran-order runs)."""
    h, w = mask.shape
    m = np.ascontiguousarray(mask, np.uint8)
    if not plain:
        counts = np.zeros(h * w + 1, np.uint32)
        n = load().rle_encode(_ptr(m, ctypes.c_uint8), h, w,
                              _ptr(counts, ctypes.c_uint32))
        return {"size": [h, w], "counts": counts[:n].copy()}
    flat = m.flatten(order="F").astype(np.int8)
    changes = np.nonzero(np.diff(flat))[0] + 1
    edges = np.concatenate([[0], changes, [flat.size]])
    runs = np.diff(edges).astype(np.uint32)
    if flat[0] == 1:
        runs = np.concatenate([[np.uint32(0)], runs])
    return {"size": [h, w], "counts": runs}


def rle_decode(rle: dict, plain: bool = False) -> np.ndarray:
    h, w = rle["size"]
    counts = np.ascontiguousarray(rle["counts"], np.uint32)
    if not plain:
        mask = np.zeros((h, w), np.uint8)
        load().rle_decode(_ptr(counts, ctypes.c_uint32), len(counts), h, w,
                          _ptr(mask, ctypes.c_uint8))
        return mask
    flat = np.zeros(h * w, np.uint8)
    pos, v = 0, 0
    for c in counts:
        if v:
            flat[pos:pos + int(c)] = 1
        pos += int(c)
        v ^= 1
    return flat.reshape((h, w), order="F")


def rle_area(rle: dict, plain: bool = False) -> float:
    counts = np.ascontiguousarray(rle["counts"], np.uint32)
    if not plain:
        return load().rle_area(_ptr(counts, ctypes.c_uint32), len(counts))
    return float(counts[1::2].sum())


def rle_iou(a: dict, b: dict, a_crowd: bool = False, plain: bool = False) -> float:
    ca = np.ascontiguousarray(a["counts"], np.uint32)
    cb = np.ascontiguousarray(b["counts"], np.uint32)
    if not plain:
        return load().rle_iou(_ptr(ca, ctypes.c_uint32), len(ca),
                              _ptr(cb, ctypes.c_uint32), len(cb),
                              1 if a_crowd else 0)
    ma = rle_decode(a, plain=True).astype(bool)
    mb = rle_decode(b, plain=True).astype(bool)
    inter = float(np.sum(ma & mb))
    union = float(np.sum(mb)) if a_crowd else float(np.sum(ma | mb))
    return inter / union if union > 0 else 0.0
