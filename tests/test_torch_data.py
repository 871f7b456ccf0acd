"""The port's data layer (object_detectors_tpu_torch/data/: coco, transforms,
synthetic, grouping, masks, idf, class_names; utils/config and
utils/logging) against the JAX package's, on the CPU.

Everything here is numpy on the host in both packages, with cv2 and Pillow
as the image libraries, so the same seeded inputs (and the same
``RandomState`` draws) give bitwise the same arrays: every comparison is
exact, dtypes included. The idf CSV crosses between the packages (pandas
writes and reads the JAX package's; the csv module the port's) within
1e-12 relative."""

import gc
import os
import sys
import threading
import time

import numpy as np
import pytest

from object_detectors_tpu.data import class_names as JCN
from object_detectors_tpu.data import coco as JD
from object_detectors_tpu.data import grouping as JG
from object_detectors_tpu.data import idf as JIDF
from object_detectors_tpu.data import masks as JM
from object_detectors_tpu.data import synthetic as JS
from object_detectors_tpu.data import transforms as JT
from object_detectors_tpu.utils import config as JC
from object_detectors_tpu.utils import logging as JL
from object_detectors_tpu_torch.data import class_names as CN
from object_detectors_tpu_torch.data import coco as D
from object_detectors_tpu_torch.data import grouping as G
from object_detectors_tpu_torch.data import idf as IDF
from object_detectors_tpu_torch.data import masks as M
from object_detectors_tpu_torch.data import synthetic as S
from object_detectors_tpu_torch.data import transforms as T
from object_detectors_tpu_torch.utils import config as C
from object_detectors_tpu_torch.utils import logging as L


def assert_same(a, b, path="out"):
    """Exact equality of nested outputs: arrays by value and dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (path, a.dtype, b)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def synth_images(gt):
    return {im["id"]: (np.random.RandomState(im["id"])
                       .randint(0, 255, (im["height"], im["width"], 3)).astype(np.uint8))
            for im in gt["images"]}


@pytest.fixture(scope="module")
def synth():
    """The JAX test fixture's set (tests/test_data_eval_pipeline.py): 10
    images of 96² with 4 classes, seeded random pixels; one dataset of
    each package over it."""
    gt = JS.make_coco_dicts(np.random.RandomState(0), num_images=10, img_size=96,
                            num_classes=4)
    imgs = synth_images(gt)

    def loader(info):
        return imgs[info["id"]]

    return (gt, JD.CocoDetectionDataset(gt, label_mode="raw", image_loader=loader),
            D.CocoDetectionDataset(gt, label_mode="raw", image_loader=loader))


def test_class_names_and_label_maps_are_jax_s():
    assert CN.COCO_NAMES == JCN.COCO_NAMES
    assert T.COCO_91_TO_80 == JT.COCO_91_TO_80
    np.testing.assert_array_equal(T.IMAGENET_MEAN, JT.IMAGENET_MEAN)
    np.testing.assert_array_equal(T.IMAGENET_STD, JT.IMAGENET_STD)


@pytest.mark.parametrize("kwargs", [
    {}, {"with_segmentation": True}, {"with_keypoints": True, "num_keypoints": 5}])
def test_synthetic_sets_are_jax_s(kwargs):
    assert_same(S.make_coco_dicts(np.random.RandomState(3), 6, 64, 5, **kwargs),
                JS.make_coco_dicts(np.random.RandomState(3), 6, 64, 5, **kwargs))
    assert_same(S.make_batch(np.random.RandomState(4), 3, 32, 5, 7),
                JS.make_batch(np.random.RandomState(4), 3, 32, 5, 7))
    gt, loader = S.renderable_dataset(np.random.RandomState(5), 4, 48, 3)
    jgt, jloader = JS.renderable_dataset(np.random.RandomState(5), 4, 48, 3)
    assert_same(gt, jgt)
    for info in gt["images"]:
        assert_same(loader(info), jloader(info))


@pytest.mark.parametrize("label_mode", ["coco80", "lvis0", "raw"])
@pytest.mark.parametrize("subset", [1.0, 0.5])
def test_dataset_items_are_jax_s(synth, label_mode, subset):
    gt, _, _ = synth
    imgs = synth_images(gt)
    # a crowd annotation and an image without annotations, both dropped
    gt = {**gt, "annotations": gt["annotations"] + [
        {**gt["annotations"][0], "id": 999, "iscrowd": 1}]}
    gt["images"] = gt["images"] + [{"id": 11, "width": 96, "height": 96,
                                    "file_name": "x.jpg"}]
    kw = dict(label_mode=label_mode, subset=subset, image_loader=lambda i: imgs[i["id"]])
    ours = D.CocoDetectionDataset(gt, rng=np.random.RandomState(7), **kw)
    ref = JD.CocoDetectionDataset(gt, rng=np.random.RandomState(7), **kw)
    assert ours.ids == ref.ids and len(ours) == len(ref)
    for i in range(len(ref)):
        assert_same(ours[i], ref[i])
        assert ours.map_label(5) == ref.map_label(5)


def test_keypoint_targets_are_jax_s():
    gt = JS.make_coco_dicts(np.random.RandomState(8), 3, 64, 2, with_keypoints=True)
    del gt["annotations"][1]["keypoints"]  # a missing field -> all invisible
    kw = dict(label_mode="raw", image_loader=lambda i: np.zeros((64, 64, 3), np.uint8))
    ours, ref = D.CocoDetectionDataset(gt, **kw), JD.CocoDetectionDataset(gt, **kw)
    for i in range(len(ref)):
        assert_same(ours[i], ref[i])


def test_load_image_reads_a_file_as_jax_does(tmp_path):
    import cv2

    img = np.random.RandomState(9).randint(0, 255, (20, 30, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    gt = {"images": [{"id": 1, "width": 30, "height": 20, "file_name": "a.png"}],
          "annotations": [{"id": 1, "image_id": 1, "category_id": 1,
                           "bbox": [1.0, 2.0, 5.0, 6.0], "area": 30.0, "iscrowd": 0}],
          "categories": [{"id": 1, "name": "a"}]}
    ours = D.CocoDetectionDataset(gt, str(tmp_path))
    assert_same(ours[0], JD.CocoDetectionDataset(gt, str(tmp_path))[0])
    missing = D.CocoDetectionDataset(gt, str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError):
        missing[0]


@pytest.mark.parametrize("n,world,shuffle", [(10, 4, True), (10, 1, False), (7, 3, True),
                                             (12, 4, False)])
def test_shard_indices_are_jax_s(n, world, shuffle):
    for rank in range(world):
        assert_same(D.shard_indices(n, rank, world, shuffle, 1),
                    JD.shard_indices(n, rank, world, shuffle, 1))


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("kind", ["yolo_batches", "yolo_batches_uint8"])
def test_batches_are_jax_s(synth, kind, augment):
    """The whole batch pipeline, 96² images to 64 (a true cv2 resize), with
    and without the augment family on the same RandomState seed."""
    _, jds, ds = synth
    kw = dict(batch_size=4, inp_dim=64, max_boxes=8, shuffle=True, seed=2)
    if kind == "yolo_batches_uint8":
        kw["canvas_size"] = 96
    ours = list(getattr(D, kind)(ds, augment_rng=np.random.RandomState(3) if augment
                                 else None, **kw))
    ref = list(getattr(JD, kind)(jds, augment_rng=np.random.RandomState(3) if augment
                                 else None, **kw))
    assert len(ours) == len(ref) == 3
    assert_same(ours, ref)


def test_uint8_batches_downscale_an_image_larger_than_the_canvas(synth):
    """Images of 96² into a 64² canvas take the Pillow downscale."""
    _, jds, ds = synth
    kw = dict(batch_size=4, inp_dim=32, canvas_size=64, max_boxes=8)
    ours, ref = list(D.yolo_batches_uint8(ds, **kw)), list(JD.yolo_batches_uint8(jds, **kw))
    assert_same(ours, ref)
    assert (ours[0]["sizes"] == 64).all()


def test_abandoned_iterator_leaks_no_worker_thread(synth):
    _, _, ds = synth
    before = threading.active_count()
    for close in (True, False):
        it = D.yolo_batches(ds, batch_size=2, inp_dim=64, max_boxes=8, prefetch=1)
        next(it)  # the worker is live and blocked on the depth-1 queue
        if close:
            it.close()
        del it
        gc.collect()
        t0 = time.monotonic()
        while threading.active_count() > before and time.monotonic() - t0 < 5.0:
            time.sleep(0.01)
        assert threading.active_count() <= before


def test_prefetched_reraises_the_worker_error():
    def boom(i0):
        if i0 >= 2:
            raise RuntimeError("worker failed")
        return i0

    out = []
    with pytest.raises(RuntimeError, match="worker failed"):
        for x in D._prefetched(boom, range(0, 6, 2), depth=1):
            out.append(x)
    assert out == [0]


def _image(seed, h=40, w=56):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(np.uint8)


BOXES = np.array([[4.0, 5.0, 30.0, 25.0], [20.0, 2.0, 50.0, 38.0], [1.0, 30.0, 9.0, 39.0]],
                 np.float32)
LABELS = np.array([1, 2, 3], np.int32)
KEYPOINTS = np.random.RandomState(11).rand(2, 17, 3).astype(np.float32) * 30
KEYPOINTS[0, 3, 2] = 0

TRANSFORMS = {
    "resize_to_tensor": lambda t, rng: t.resize_to_tensor(_image(1), BOXES, 32),
    "resize_to_tensor same size": lambda t, rng: t.resize_to_tensor(_image(1, 32, 32),
                                                                     BOXES, 32),
    "resize_to_tensor no boxes": lambda t, rng: t.resize_to_tensor(
        _image(1), np.zeros((0, 4), np.float32), 48),
    "normalize_image u8": lambda t, rng: t.normalize_image(_image(2)),
    "normalize_image unit": lambda t, rng: t.normalize_image(_image(2) / 255.0),
    "min_max_resize_factor": lambda t, rng: [t.min_max_resize_factor(h, w, 64, 100)
                                             for h, w in ((40, 56), (30, 120), (64, 64))],
    "rcnn_resize": lambda t, rng: t.rcnn_resize(_image(3), BOXES, 64, 100),
    "rcnn_resize pad_to": lambda t, rng: t.rcnn_resize(_image(3), BOXES, 64, 100,
                                                       pad_to=(64, 80)),
    "rcnn_resize same size": lambda t, rng: t.rcnn_resize(_image(3), BOXES, 40, 100),
    "hflip": lambda t, rng: t.hflip(_image(4), BOXES),
    "hflip_keypoints": lambda t, rng: t.hflip_keypoints(KEYPOINTS, 56),
    "photometric augments": lambda t, rng: [
        getattr(t, name)(rng, _image(5)) for name in
        ("_aug_contrast", "_aug_grayscale", "_aug_blur", "_aug_noise", "_aug_dropout",
         "_aug_cutout") for _ in range(3)],
    "_aug_affine": lambda t, rng: [t._aug_affine(rng, _image(6), BOXES) for _ in range(4)],
    "yolo_augment": lambda t, rng: [t.yolo_augment(rng, _image(7), BOXES, LABELS)
                                    for _ in range(12)],
    "random_iou_crop": lambda t, rng: [t.random_iou_crop(rng, _image(8), BOXES, LABELS)
                                       for _ in range(6)],
    "random_zoom_out": lambda t, rng: [t.random_zoom_out(rng, _image(9), BOXES)
                                       for _ in range(3)],
    "photometric_distort": lambda t, rng: [t.photometric_distort(rng, _image(10))
                                           for _ in range(6)],
    "pad_targets": lambda t, rng: [t.pad_targets(BOXES, LABELS, m) for m in (2, 5)],
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_is_jax_s(name):
    ours = TRANSFORMS[name](T, np.random.RandomState(12))
    ref = TRANSFORMS[name](JT, np.random.RandomState(12))
    assert_same(ours, ref)


def test_same_size_resize_needs_no_image_library(monkeypatch):
    """With cv2 and Pillow unimportable a resize to the image's own size
    still runs (both return such an image unchanged); a true resize raises,
    naming both libraries."""
    for name in ("cv2", "PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, name, None)
    img = _image(13, 32, 32)
    assert_same(T.resize_to_tensor(img, BOXES, 32), JT.resize_to_tensor(img, BOXES, 32))
    with pytest.raises(RuntimeError, match="cv2.*Pillow"):
        T.resize_to_tensor(img, BOXES, 48)
    with pytest.raises(RuntimeError, match="cv2.*Pillow"):
        T.rcnn_resize(img, BOXES, 64, 100)


def test_grouping_is_jax_s():
    assert G.aspect_ratio_bins(3) == JG.aspect_ratio_bins(3)
    ars = np.random.RandomState(14).rand(40) * 3 + 0.2
    bins = G.aspect_ratio_bins(2)
    assert_same(G.group_ids(ars, bins), JG.group_ids(ars, bins))
    gid = G.group_ids(ars, bins)
    for shuffle in (False, True):
        assert G.grouped_batch_indices(gid, 4, shuffle, 3) == \
            JG.grouped_batch_indices(gid, 4, shuffle, 3)
    gt = JS.make_coco_dicts(np.random.RandomState(15), 5, 64, 2)
    gt["images"][1]["width"] = 100
    ds = D.CocoDetectionDataset(gt, image_loader=lambda i: None)
    assert_same(G.dataset_aspect_ratios(ds),
                JG.dataset_aspect_ratios(JD.CocoDetectionDataset(gt,
                                                                image_loader=lambda i: None)))


def _rle_of(mask):
    """pycocotools' compressed RLE string of a mask (the encoder of
    maskApi.c rleToString), to feed the decoder."""
    flat = mask.flatten(order="F")
    runs, prev, n = [], 0, 0
    for v in flat:
        if v == prev:
            n += 1
        else:
            runs.append(n)
            prev, n = v, 1
    runs.append(n)
    out = []
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


MASK_CASES = {
    "rasterize_polygon": lambda m: [m.rasterize_polygon(np.array(p, np.float64), 24, 30)
                                    for p in ([[2, 3], [20, 3], [20, 15], [2, 15]],
                                              [[5, 1], [25, 20], [1, 22]], [[1, 1], [3, 3]])],
    "segmentation_to_mask polygons": lambda m: m.segmentation_to_mask(
        [[4, 4, 14, 4, 14, 14, 4, 14], [16, 2, 28, 6, 20, 18]], 24, 30),
    "segmentation_to_mask RLE": lambda m: [
        m.segmentation_to_mask({"size": [24, 30], "counts": c}, 24, 30)
        for c in ([5, 10, 100, 20, 300, 285], _rle_of(RAND_MASK))],
    "_decode_compressed_rle": lambda m: m._decode_compressed_rle(_rle_of(RAND_MASK), 24, 30),
    "filter_degenerate": lambda m: m.filter_degenerate(
        np.array([[0, 0, 5, 5], [3, 3, 3, 9], [4, 4, 9, 2]], np.float64)),
    "masks_for_annotations": lambda m: [
        m.masks_for_annotations([], 8, 8),
        m.masks_for_annotations([{"segmentation": [[1, 1, 6, 1, 6, 6]]},
                                 {"segmentation": {"size": [8, 8], "counts": [9, 5, 50]}}],
                                8, 8)],
    "paste_mask": lambda m: [m.paste_mask(np.random.RandomState(16).rand(14, 14)
                                          .astype(np.float32), np.array(b), 40, 48)
                             for b in ([4.0, 4.0, 30.5, 20.2], [-5.0, 10.0, 60.0, 50.0])],
}
RAND_MASK = (np.random.RandomState(17).rand(24, 30) > 0.6).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_masks_are_jax_s(name):
    assert_same(MASK_CASES[name](M), MASK_CASES[name](JM))


def test_compressed_rle_decodes_to_the_mask():
    got = M.segmentation_to_mask({"size": [24, 30], "counts": _rle_of(RAND_MASK)}, 24, 30)
    np.testing.assert_array_equal(got, RAND_MASK)


@pytest.mark.parametrize("seed,num_classes", [(1, 5), (2, 3), (3, 12)])
def test_idf_tables_are_jax_s(seed, num_classes):
    gt = JS.make_coco_dicts(np.random.RandomState(seed), 30, 64, num_classes)
    gt["annotations"] = [a for a in gt["annotations"] if a["category_id"] != 2]
    ours, ref = IDF.idf_tables(gt), JIDF.idf_tables(gt)
    assert IDF.VARIANTS == JIDF.VARIANTS
    assert_same(ours, ref)


def test_idf_csv_crosses_between_the_packages(tmp_path):
    gt = JS.make_coco_dicts(np.random.RandomState(2), 20, 64, 3)
    t = IDF.idf_tables(gt)
    t["prob"][0] = np.nan  # an empty field in pandas' file
    t["raw"][1] = np.inf
    written = {"port": str(tmp_path / "port.csv"), "jax": str(tmp_path / "jax.csv")}
    IDF.save_idf_csv(t, written["port"])
    JIDF.save_idf_csv(t, written["jax"])
    assert open(written["port"]).read() == open(written["jax"]).read()
    for path in written.values():
        for loaded in (IDF.load_idf_csv(path), JIDF.load_idf_csv(path)):
            assert sorted(loaded) == sorted(k for k in t if not k.startswith("_"))
            for k, v in loaded.items():
                np.testing.assert_allclose(np.asarray(v, np.float64), t[k], rtol=1e-12,
                                           err_msg=k)


CONFIG_OVERRIDES = [[], ["dataset=lvis", "yolo.lambda_xy=0.411", "epochs=7"],
                    ["neck.spp=true", "multiscaler.bounds=[0.7,1.2]"],
                    ["experiment.name=exp42"]]


@pytest.mark.parametrize("overrides", CONFIG_OVERRIDES, ids=str)
def test_config_is_jax_s(overrides):
    """The port reads the repository's configs/ as the JAX package does."""
    assert C.CONFIG_DIR == os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs")
    ours = C.load_config(C.CONFIG_DIR, overrides)
    assert ours == JC.load_config(C.CONFIG_DIR, overrides)
    assert ours.yolo.classes == ours.dataset.num_classes


def test_logging_is_jax_s(tmp_path, monkeypatch):
    for mod in (L, JL):
        v = mod.SmoothedValue(window_size=3)
        for x in (1.0, 2.0, 3.0, 4.0):
            v.update(x)
        assert (v.value, v.avg, v.global_avg, v.median, str(v)) == (4.0, 3.0, 2.5, 3.0,
                                                                      "3.0000 (2.5000)")
        lines = []
        ml = mod.MetricLogger()
        ml.update(loss=1.5)
        assert list(ml.log_every(range(5), 2, "hdr", printer=lines.append)) == list(range(5))
        assert len(lines) == 4 and "loss: 1.5000" in lines[0]
        mod.write_progress_stats(str(tmp_path / f"{mod.__name__}.csv"), 0, np.arange(6.0),
                                 np.arange(5.0), 0.5)
    assert open(tmp_path / f"{L.__name__}.csv").read() == \
        open(tmp_path / f"{JL.__name__}.csv").read()
    # without TensorBoard the writer is a no-op, as the JAX package's
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tb = L.TensorBoardWriter(str(tmp_path / "tb"))
    tb.scalar("loss", 1.0, 0)
    tb.close()
    assert tb._w is None and not (tmp_path / "tb").exists()
