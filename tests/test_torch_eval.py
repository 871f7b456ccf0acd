"""The port's evaluators (object_detectors_tpu_torch/eval/: coco_map,
lvis_map, evaluator, native with csrc/coco_eval_core.cpp) against the JAX
package's, on the CPU.

Both run the same numpy arithmetic and the same C++ matcher, so the stats
must agree exactly (the same 12 floats, -1 where a cell is empty). The
port's native core is also held against its plain versions (the Python
matcher loop and the numpy RLE routines, reached by ``plain=True``):
identical results, as tests/test_native.py holds the JAX package's."""

import json

import numpy as np
import pytest
import torch

from object_detectors_tpu.data import synthetic as JS
from object_detectors_tpu.eval import coco_map as JCM
from object_detectors_tpu.eval import evaluator as JE
from object_detectors_tpu.eval import lvis_map as JL
from object_detectors_tpu_torch.eval import coco_map as CM
from object_detectors_tpu_torch.eval import evaluator as E
from object_detectors_tpu_torch.eval import lvis_map as L
from object_detectors_tpu_torch.eval import native as N
from object_detectors_tpu_torch.kernels import _build


def make_gt(boxes_per_image, img_size=100, num_classes=3):
    """boxes_per_image: {img_id: [(cat, x, y, w, h), ...]} (tests/test_coco_eval.py)."""
    images = [{"id": i, "width": img_size, "height": img_size, "file_name": f"{i}.jpg"}
              for i in boxes_per_image]
    anns, aid = [], 1
    for img_id, boxes in boxes_per_image.items():
        for cat, x, y, w, h in boxes:
            anns.append({"id": aid, "image_id": img_id, "category_id": cat,
                         "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0})
            aid += 1
    cats = [{"id": c, "name": str(c)} for c in range(1, num_classes + 1)]
    return {"images": images, "annotations": anns, "categories": cats}


def det(img, cat, box, score):
    return {"image_id": img, "category_id": cat, "bbox": list(box), "score": score}


def crowd_case():
    gt = make_gt({1: [(1, 0, 0, 10, 10)]})
    gt["annotations"][0]["iscrowd"] = 1
    gt["annotations"].append({"id": 99, "image_id": 1, "category_id": 1,
                              "bbox": [50, 50, 10, 10], "area": 100, "iscrowd": 0})
    return gt, [det(1, 1, (0, 0, 10, 10), 0.9), det(1, 1, (50, 50, 10, 10), 0.8)]


def jittered_case(seed, num_images=20, num_classes=5, crowd=False):
    """GT of a synthetic set as detections, jittered, some dropped and some
    duplicated, with random scores (tests/test_native.py's case, widened)."""
    rng = np.random.RandomState(seed)
    gt = JS.make_coco_dicts(rng, num_images=num_images, img_size=128,
                            num_classes=num_classes)
    if crowd:
        for a in gt["annotations"][::7]:
            a["iscrowd"] = 1
    dts = []
    for a in gt["annotations"]:
        for _ in range(rng.randint(0, 3)):
            b = list(a["bbox"])
            b[0] += rng.randn() * 3
            b[2] *= rng.uniform(0.8, 1.2)
            dts.append(det(a["image_id"], int(rng.randint(1, num_classes + 1))
                           if rng.rand() < 0.1 else a["category_id"], b, float(rng.rand())))
    return gt, dts


COCO_CASES = {
    "perfect": lambda: (make_gt({1: [(1, 10, 10, 20, 20), (2, 50, 50, 30, 10)],
                                 2: [(1, 5, 5, 40, 40)]}),
                        [det(1, 1, (10, 10, 20, 20), 0.9), det(1, 2, (50, 50, 30, 10), 0.8),
                         det(2, 1, (5, 5, 40, 40), 0.95)]),
    "no detections": lambda: (make_gt({1: [(1, 10, 10, 20, 20)]}), []),
    "half recall": lambda: (make_gt({1: [(1, 10, 10, 20, 20), (1, 60, 60, 20, 20)]}),
                            [det(1, 1, (10, 10, 20, 20), 0.9)]),
    "IoU threshold cutoff": lambda: (make_gt({1: [(1, 0, 0, 10, 10)]}),
                                     [det(1, 1, (0, 0, 10, 6), 0.9)]),
    "precision envelope": lambda: (make_gt({1: [(1, 0, 0, 10, 10), (1, 50, 50, 10, 10)]}),
                                   [det(1, 1, (0, 0, 10, 10), 0.9),
                                    det(1, 1, (80, 80, 5, 5), 0.8),
                                    det(1, 1, (50, 50, 10, 10), 0.7)]),
    "duplicates": lambda: (make_gt({1: [(1, 0, 0, 10, 10)]}),
                           [det(1, 1, (0, 0, 10, 10), 0.9), det(1, 1, (0, 0, 10, 10), 0.8)]),
    "crowd GT": crowd_case,
    "area ranges": lambda: (make_gt({1: [(1, 0, 0, 10, 10), (1, 20, 20, 97, 97)]}),
                            [det(1, 1, (0, 0, 10, 10), 0.9)]),
    "wrong class": lambda: (make_gt({1: [(1, 0, 0, 10, 10)]}),
                            [det(1, 2, (0, 0, 10, 10), 0.9)]),
    "per-class, one class never annotated": lambda: (
        make_gt({1: [(1, 0, 0, 10, 10), (2, 50, 50, 10, 10)]}),
        [det(1, 1, (0, 0, 10, 10), 0.9)]),
    "synthetic self-consistency": lambda: (
        lambda gt: (gt, [det(a["image_id"], a["category_id"], a["bbox"], 0.9)
                         for a in gt["annotations"]]))(
        JS.make_coco_dicts(np.random.RandomState(0), num_images=8, num_classes=4)),
    "jittered": lambda: jittered_case(2),
    "jittered with crowds": lambda: jittered_case(3, crowd=True),
}


@pytest.mark.parametrize("name", sorted(COCO_CASES))
def test_coco_eval_is_jax_s(name):
    gt, dts = COCO_CASES[name]()
    ev = CM.COCOEvalNP(gt, dts).evaluate_and_accumulate()
    ref = JCM.COCOEvalNP(gt, dts).evaluate_and_accumulate()
    np.testing.assert_array_equal(ev.summarize(), ref.summarize())
    np.testing.assert_array_equal(ev.eval["precision"], ref.eval["precision"])
    np.testing.assert_array_equal(ev.eval["recall"], ref.eval["recall"])
    assert ev.per_category_ap() == ref.per_category_ap()
    np.testing.assert_array_equal(CM.evaluate_detections(gt, dts),
                                  JCM.evaluate_detections(gt, dts))
    # the native matcher is its plain version
    np.testing.assert_array_equal(CM.evaluate_detections(gt, dts, plain=True),
                                  ev.summarize())


def make_lvis_gt():
    """tests/test_lvis_grouping.py's set: image 1 negative for class 2,
    image 2 not exhaustive for class 1; classes rare, frequent, common."""
    images = [{"id": 1, "width": 100, "height": 100, "neg_category_ids": [2],
               "not_exhaustive_category_ids": []},
              {"id": 2, "width": 100, "height": 100, "neg_category_ids": [],
               "not_exhaustive_category_ids": [1]}]
    annotations = [{"id": 1, "image_id": 1, "category_id": 1, "bbox": [10, 10, 20, 20],
                    "area": 400, "iscrowd": 0},
                   {"id": 2, "image_id": 2, "category_id": 1, "bbox": [40, 40, 20, 20],
                    "area": 400, "iscrowd": 0}]
    categories = [{"id": 1, "name": "a", "image_count": 2},
                  {"id": 2, "name": "b", "image_count": 500},
                  {"id": 3, "name": "c", "image_count": 50}]
    return {"images": images, "annotations": annotations, "categories": categories}


def lvis_jittered():
    gt, dts = jittered_case(4, num_images=12, num_classes=4)
    for im in gt["images"]:
        im["neg_category_ids"] = [1 + im["id"] % 4]
        im["not_exhaustive_category_ids"] = [1 + (im["id"] + 1) % 4]
    for c in gt["categories"]:  # no image_count: counted from the annotations
        c.pop("image_count", None)
    return gt, dts


LVIS_CASES = {
    "perfect": [det(1, 1, (10, 10, 20, 20), 0.9), det(2, 1, (40, 40, 20, 20), 0.9)],
    "federated FP ignored": [det(1, 1, (10, 10, 20, 20), 0.9),
                             det(2, 1, (40, 40, 20, 20), 0.9), det(1, 3, (0, 0, 10, 10), 0.95)],
    "negative image FP": [det(1, 2, (0, 0, 10, 10), 0.9)],
    "not exhaustive, unmatched ignored": [det(1, 1, (10, 10, 20, 20), 0.9),
                                          det(2, 1, (40, 40, 20, 20), 0.9),
                                          det(2, 1, (70, 70, 20, 20), 0.95)],
    "jittered": None,
}


@pytest.mark.parametrize("name", sorted(LVIS_CASES))
def test_lvis_eval_is_jax_s(name):
    gt, dts = (make_lvis_gt(), LVIS_CASES[name]) if LVIS_CASES[name] is not None \
        else lvis_jittered()
    ev = L.LVISEvalNP(gt, dts).evaluate_and_accumulate()
    ref = JL.LVISEvalNP(gt, dts).evaluate_and_accumulate()
    np.testing.assert_array_equal(ev.summarize(), ref.summarize())
    assert ev.freq_group == ref.freq_group
    np.testing.assert_array_equal(
        L.LVISEvalNP(gt, dts, plain=True).evaluate_and_accumulate().summarize(),
        ev.summarize())


def box_rle(x, y, w, h, size=32):
    """Uncompressed RLE (counts as a list) of a filled box."""
    m = np.zeros((size, size), np.uint8)
    m[y:y + h, x:x + w] = 1
    return {"size": [size, size], "counts": N.rle_encode(m, plain=True)["counts"].tolist()}


def segm_gt():
    """tests/test_masks_segm_eval.py's one-box set, plus a crowd RLE GT."""
    return {"images": [{"id": 1, "width": 32, "height": 32}],
            "annotations": [{"id": 1, "image_id": 1, "category_id": 1,
                             "bbox": [4, 4, 10, 10], "area": 100, "iscrowd": 0,
                             "segmentation": [[4, 4, 14, 4, 14, 14, 4, 14]]},
                            {"id": 2, "image_id": 1, "category_id": 1,
                             "bbox": [18, 18, 8, 8], "area": 64, "iscrowd": 1,
                             "segmentation": box_rle(18, 18, 8, 8)}],
            "categories": [{"id": 1, "name": "a"}]}


SEGM_CASES = {
    "perfect": [{"image_id": 1, "category_id": 1, "bbox": [4, 4, 10, 10], "score": 0.9,
                 "segmentation": [[4, 4, 14, 4, 14, 14, 4, 14]]}],
    "mismatched mask": [{"image_id": 1, "category_id": 1, "bbox": [4, 4, 10, 10],
                         "score": 0.9, "segmentation": [[4, 4, 9, 4, 9, 9, 4, 9]]}],
    "on the crowd, box as mask": [{"image_id": 1, "category_id": 1, "bbox": [18, 18, 8, 8],
                                   "score": 0.8},
                                  {"image_id": 1, "category_id": 1, "bbox": [4, 4, 10, 10],
                                   "score": 0.7, "area": 100.0,
                                   "segmentation": box_rle(4, 4, 10, 10)}],
}


@pytest.mark.parametrize("name", sorted(SEGM_CASES))
def test_segm_eval_is_jax_s(name):
    gt, dts = segm_gt(), SEGM_CASES[name]
    ours = CM.COCOEvalNP(gt, dts, iou_type="segm").evaluate_and_accumulate().summarize()
    ref = JCM.COCOEvalNP(gt, dts, iou_type="segm").evaluate_and_accumulate().summarize()
    np.testing.assert_array_equal(ours, ref)
    plain = CM.COCOEvalNP(gt, dts, iou_type="segm", plain=True)
    np.testing.assert_array_equal(plain.evaluate_and_accumulate().summarize(), ours)


def keypoint_case(unlabeled):
    gt = JS.make_coco_dicts(np.random.RandomState(0), 3, 128, 1, with_keypoints=True)
    if unlabeled:
        gt["annotations"][0]["keypoints"] = [0.0] * 51
        gt["annotations"][0]["num_keypoints"] = 0
        del gt["annotations"][1]["num_keypoints"]
    rng = np.random.RandomState(1)
    dts = [{"image_id": a["image_id"], "category_id": 1, "bbox": a["bbox"],
            "score": float(rng.rand()),
            "keypoints": (np.asarray(a["keypoints"]) + rng.randn(51) * 2).tolist()}
           for a in gt["annotations"]]
    return gt, dts


@pytest.mark.parametrize("unlabeled", [False, True])
def test_keypoint_eval_is_jax_s(unlabeled):
    gt, dts = keypoint_case(unlabeled)
    ours = CM.COCOEvalNP(gt, dts, iou_type="keypoints").evaluate_and_accumulate()
    ref = JCM.COCOEvalNP(gt, dts, iou_type="keypoints").evaluate_and_accumulate()
    assert ours.summarize().shape == (10,)
    np.testing.assert_array_equal(ours.summarize(), ref.summarize())
    kps = np.stack([np.asarray(d["keypoints"]).reshape(-1, 3) for d in dts])
    np.testing.assert_array_equal(CM.compute_oks(kps, gt["annotations"]),
                                  JCM.compute_oks(kps, gt["annotations"]))


def padded_batch(gt, image_ids, slots=6):
    """GT of ``image_ids`` as one padded batch of detections (xyxy), with a
    scale factor back to the image (the model input is half the size)."""
    b = len(image_ids)
    boxes = np.zeros((b, slots, 4), np.float32)
    labels = np.zeros((b, slots), np.int32)
    valid = np.zeros((b, slots), bool)
    for i, iid in enumerate(image_ids):
        anns = [a for a in gt["annotations"] if a["image_id"] == iid][:slots]
        for d, a in enumerate(anns):
            x, y, w, h = a["bbox"]
            boxes[i, d] = np.array([x, y, x + w, y + h]) / 2
            labels[i, d] = a["category_id"] - 1
            valid[i, d] = True
    scores = np.linspace(0.9, 0.4, b * slots, dtype=np.float32).reshape(b, slots)
    return boxes, scores, labels, valid, np.full((b, 2), 2.0, np.float32)


def test_evaluator_is_jax_s(tmp_path):
    """update (tensors in the port, numpy in JAX), summarize,
    per_category_ap and save_detections; masks and keypoints too."""
    gt = JS.make_coco_dicts(np.random.RandomState(5), 6, 64, 3, with_segmentation=True)
    ours = E.DetectionEvaluator(gt, label_map=lambda c: c + 1)
    ref = JE.DetectionEvaluator(gt, label_map=lambda c: c + 1)
    rng = np.random.RandomState(6)
    for ids in ([1, 2, 3], [4, 5, 6]):
        boxes, scores, labels, valid, scale = padded_batch(gt, ids)
        masks = rng.rand(len(ids), 6, 14, 14).astype(np.float32)
        kps = rng.rand(len(ids), 6, 17, 3).astype(np.float32) * 32
        ours.update(torch.tensor(ids), torch.from_numpy(boxes), torch.from_numpy(scores),
                    torch.from_numpy(labels), torch.from_numpy(valid), torch.from_numpy(scale),
                    masks=torch.from_numpy(masks), keypoints=torch.from_numpy(kps))
        ref.update(np.array(ids), boxes, scores, labels, valid, scale, masks=masks,
                   keypoints=kps)
    assert json.dumps(ours.results, default=E._jsonable) == \
        json.dumps(ref.results, default=JE._jsonable)
    for iou_type in ("bbox", "segm"):
        np.testing.assert_array_equal(ours.summarize(iou_type), ref.summarize(iou_type))
        assert ours.per_category_ap(iou_type) == ref.per_category_ap(iou_type)
    assert ours.summarize()[0] == 1.0
    ours.save_detections(str(tmp_path / "a" / "ours.json"))
    ref.save_detections(str(tmp_path / "ref.json"))
    assert (tmp_path / "a" / "ours.json").read_text() == (tmp_path / "ref.json").read_text()


def test_evaluator_takes_bf16_and_device_tensors_once_a_batch():
    gt = JS.make_coco_dicts(np.random.RandomState(7), 2, 64, 3)
    boxes, scores, labels, valid, scale = padded_batch(gt, [1, 2])
    ours = E.DetectionEvaluator(gt, label_map=lambda c: c + 1)
    ref = JE.DetectionEvaluator(gt, label_map=lambda c: c + 1)
    ours.update(np.array([1, 2]), torch.from_numpy(boxes).to(torch.bfloat16),
                torch.from_numpy(scores), torch.from_numpy(labels), torch.from_numpy(valid))
    ref.update(np.array([1, 2]), torch.from_numpy(boxes).to(torch.bfloat16).float().numpy(),
               scores, labels, valid)
    assert ours.results == ref.results


def test_pad_gather_merge_is_jax_s():
    """The multi-process merge with an injected two-rank all-gather: rank
    payloads of different lengths merge into one list, as in JAX
    (tests/test_coco_eval.py)."""
    gt = JS.make_coco_dicts(np.random.RandomState(0), 4, 64, 3)
    merged = {}
    for mod in (E, JE):
        r0, r1 = mod.DetectionEvaluator(gt), mod.DetectionEvaluator(gt)
        for ev, ids in ((r0, [1, 2]), (r1, [3, 4])):
            boxes, scores, labels, valid, scale = padded_batch(gt, ids)
            ev.update(np.array(ids), boxes * 2, scores, labels + 1, valid)
        other = np.frombuffer(json.dumps(r1.results, default=mod._jsonable).encode(),
                              np.uint8)

        def fake_allgather(x):
            if x.dtype == np.int32:  # the lengths round
                return np.stack([x, np.array([other.size], np.int32)])
            other_pad = np.zeros_like(x)
            other_pad[: other.size] = other
            return np.stack([x, other_pad])

        n0 = len(r0.results)
        r0.synchronize_between_processes(_allgather=fake_allgather)
        assert len(r0.results) == n0 + len(r1.results)
        merged[mod] = r0
    assert merged[E].results == merged[JE].results
    assert merged[E].summarize()[0] == 1.0
    # one process: a no-op
    before = list(merged[E].results)
    merged[E].synchronize_between_processes()
    assert merged[E].results == before


@pytest.mark.parametrize("shape", [(16, 16), (37, 23), (1, 5), (64, 3), (1, 1)])
def test_native_rle_is_its_plain_version(shape):
    rng = np.random.RandomState(sum(shape))
    for density in (0.0, 0.5, 1.0, 0.9):
        a = (rng.rand(*shape) < density).astype(np.uint8)
        b = (rng.rand(*shape) < 0.5).astype(np.uint8)
        ra, rb = N.rle_encode(a), N.rle_encode(b)
        pa = N.rle_encode(a, plain=True)
        np.testing.assert_array_equal(ra["counts"], pa["counts"])
        assert ra["size"] == pa["size"] == list(shape)
        np.testing.assert_array_equal(N.rle_decode(ra), a)
        np.testing.assert_array_equal(N.rle_decode(ra, plain=True), a)
        assert N.rle_area(ra) == N.rle_area(ra, plain=True) == a.sum()
        for crowd in (False, True):
            assert N.rle_iou(ra, rb, crowd) == N.rle_iou(ra, rb, crowd, plain=True)


def test_native_matcher_is_its_plain_version_on_random_cells():
    rng = np.random.RandomState(8)
    for d, g in ((5, 4), (12, 1), (1, 9), (30, 30)):
        iou = rng.rand(d, g) * rng.choice([0.6, 1.0], (d, g))
        gt_ignore = np.sort(rng.rand(g) < 0.3)
        crowd = rng.rand(g) < 0.2
        dts = [{"bbox": [0, 0, 1, float(a)], "score": float(s)}
               for a, s in zip(rng.rand(d) * 2000, -np.arange(d))]
        gts = [{"bbox": [0, 0, 1, 1], "area": float(a), "iscrowd": int(c), "ignore": int(i)}
               for a, c, i in zip(rng.rand(g) * 3000, crowd, gt_ignore)]
        for rng_ in CM.AREA_RNG.values():
            native = CM._evaluate_img(dts, gts, rng_, 100, lambda *_: iou)
            plain = CM._evaluate_img(dts, gts, rng_, 100, lambda *_: iou, plain=True)
            for x, y in zip(native, plain):
                np.testing.assert_array_equal(x, y)


def test_native_library_is_built_into_the_package_build_dir():
    N.load()
    path = _build.library_path("coco_eval_core")
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert _build.source_path("coco_eval_core").name == "coco_eval_core.cpp"


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build("broken")
    assert not list((tmp_path / "_build").glob("*.so"))
