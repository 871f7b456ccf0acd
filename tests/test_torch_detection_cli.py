"""The port's detection_main CLI (object_detectors_tpu_torch/detection_main.py:
``rcnn_batches``, ``build_tfidf_vector``, ``build_csl_weights``,
``evaluate``, ``main``) against the JAX package's ``detection_main.py`` on
the CPU.

* ``rcnn_batches`` is bitwise JAX's for every option: the hflip / ssd /
  ssdlite presets, aspect-ratio grouping, the random min size, masks,
  keypoints, process sharding and device ingest (its native canvas chosen
  or given, with the host downscale);
* ``build_tfidf_vector`` and ``build_csl_weights`` are bitwise JAX's;
* the slice as a whole: JAX's ``main(["--test-only", "--small", ...])`` on
  seeded variables (random frozen statistics, class scores spread apart so
  that no two detections are near-tied) against the port's ``main([...,
  "--device", "cpu", "--test-only", "--resume", "last", "--dump-json",
  ...])`` on a port checkpoint of the same variables
  (``flax_frcnn_to_torch``): the same detections JSON (ids and categories
  exact, boxes and scores within 1e-4 as ``tests/test_torch_frcnn.py``) and
  mAP within 1e-6;
* a port-only one-epoch ``--small`` run of each of the five ``--model``s
  (64², SSD at 300²), then ``--test-only --resume last``, prints bbox mAP,
  with segm for Mask R-CNN and keypoints for Keypoint R-CNN, as JAX does."""

import argparse
import json

import jax
import numpy as np
import pytest
import torch

from object_detectors_tpu import detection_main as JDM
from object_detectors_tpu.data import coco as JD
from object_detectors_tpu.data import synthetic as jsynthetic
from object_detectors_tpu_torch import detection_main as DM
from object_detectors_tpu_torch.data import coco as D
from object_detectors_tpu_torch.train import optim, trainer
from object_detectors_tpu_torch.utils import weights as W
from test_torch_detection_main import scale_class_scores
from test_torch_frcnn import randomized_frozen
from test_torch_mask_rcnn import RCNN_SPECIAL, seeded_params
from torch_threads import share_cores  # noqa: F401 (autouse)

SIZES = [(96, 96), (64, 128), (128, 64), (80, 120), (120, 72), (96, 96), (50, 150)]


@pytest.fixture(autouse=True)
def _drop_checkpoint_files(tmp_path):
    """The checkpoints a test writes are hundreds of MB: delete them after it."""
    yield
    for path in tmp_path.rglob("*.pt"):
        path.unlink()


def _datasets(sized=False, n=7):
    """The same synthetic set (boxes, polygons, keypoints) in both packages'
    CocoDetectionDataset; with ``sized`` the images take SIZES' shapes."""
    gt = jsynthetic.make_coco_dicts(np.random.RandomState(0), n, 96, 4,
                                    with_segmentation=True, with_keypoints=True)
    if sized:
        for im, (h, w) in zip(gt["images"], SIZES):
            im["height"], im["width"] = h, w

    def loader(info):
        return np.random.RandomState(info["id"]).randint(
            0, 255, (info["height"], info["width"], 3)).astype(np.uint8)
    return (D.CocoDetectionDataset(gt, label_mode="lvis0", image_loader=loader),
            JD.CocoDetectionDataset(gt, label_mode="lvis0", image_loader=loader))


CASES = {
    "eval": dict(),
    "hflip": dict(shuffle=True, seed=3, rng=True),
    "ssd": dict(shuffle=True, seed=1, rng=True, augmentation="ssd"),
    "ssdlite": dict(rng=True, augmentation="ssdlite"),
    "ar_groups": dict(sized=True, shuffle=True, seed=2, rng=True, ar_group_factor=3),
    "random_min_size": dict(sized=True, rng=True, min_size=(64, 80, 96), max_size=150),
    "masks": dict(sized=True, rng=True, with_masks=True),
    "keypoints": dict(sized=True, rng=True, with_keypoints=True),
    "sharded": dict(shuffle=True, seed=4, process_index=1, process_count=2),
    "ingest": dict(sized=True, rng=True, device_ingest=True, min_size=(64, 96),
                   with_masks=True, with_keypoints=True),
    "ingest_downscale": dict(sized=True, device_ingest=True, native_canvas=100,
                             with_masks=True, with_keypoints=True, max_size=150),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rcnn_batches_are_jax_s(case):
    kw = dict(CASES[case])
    ds, jds = _datasets(kw.pop("sized", False))
    rng = kw.pop("rng", False)
    kw.setdefault("min_size", 96)
    kw.setdefault("max_size", 192)
    ours = list(DM.rcnn_batches(ds, 3, 112, max_boxes=6, **kw,
                                hflip_rng=np.random.RandomState(7) if rng else None))
    ref = list(JDM.rcnn_batches(jds, 3, 112, max_boxes=6, **kw,
                                hflip_rng=np.random.RandomState(7) if rng else None))
    assert len(ours) == len(ref) > 0
    for b, jb in zip(ours, ref):
        assert list(b) == list(jb)
        for k in b:
            assert b[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)


@pytest.mark.parametrize("tfidf,norm,csl", [(None, 0, None), ("smooth", 0, "eff_samp"),
                                            ("raw", 2, "smooth"), ("smooth", 1, "raw")])
def test_tfidf_and_csl_vectors_are_jax_s(tfidf, norm, csl):
    gt = jsynthetic.make_coco_dicts(np.random.RandomState(5), 12, 96, 4)
    args = argparse.Namespace(tfidf=tfidf, tfidf_norm=norm, csl=csl)
    for ours, ref in ((DM.build_tfidf_vector(args, gt, 5), JDM.build_tfidf_vector(args, gt, 5)),
                      (DM.build_csl_weights(args, gt, 5), JDM.build_csl_weights(args, gt, 5))):
        if ref is None or isinstance(ref, float):
            assert ours == ref
        else:
            assert ours.dtype == np.float32
            np.testing.assert_array_equal(ours, np.asarray(ref))
    with pytest.raises(SystemExit):
        DM.build_tfidf_vector(argparse.Namespace(tfidf="nope", tfidf_norm=0, csl=None), gt, 5)


# -- the slice as a whole -------------------------------------------------------------

NAME, NCLS, SIZE = "fasterrcnn_resnet50_fpn", 5, 96
CLI = ["--dataset", "synthetic", "--model", NAME, "--small", "--image-size", str(SIZE),
       "--batch-size", "4", "--test-only"]


def test_test_only_resume_matches_jax(tmp_path, monkeypatch):
    jax_ad = JDM.ModelAdapter(NAME, NCLS, SIZE, resnet_layers=(1, 1, 1, 1), small=True)
    shapes = jax.eval_shape(jax_ad.init_variables, jax.random.key(0))
    v = {"params": scale_class_scores(NAME, seeded_params(dict(shapes["params"]), 0,
                                                          {**RCNN_SPECIAL, "head": 0.01})),
         "frozen": randomized_frozen(shapes["frozen"], 1)}
    monkeypatch.setattr(JDM.ModelAdapter, "init_variables", lambda self, rng: v)
    jmap = JDM.main([*CLI, "--output-dir", str(tmp_path / "jax"),
                     "--dump-json", str(tmp_path / "jax.json")])

    port = DM.ModelAdapter(NAME, NCLS, SIZE, resnet_layers=(1, 1, 1, 1), small=True,
                           device="cpu")
    port.model.load_state_dict(W.flax_frcnn_to_torch(v["params"], v["frozen"]))
    state = trainer.create_detection_train_state(port, optim.make_optimizer(
        optim.OptimizerConfig("sgd", 0.0025, 1e-4, 0.9), optim.SchedulerConfig("multistep")))
    ckpt = DM.ckpt_lib.CheckpointManager(str(tmp_path / "port" / "checkpoints"))
    DM._save(ckpt, "last", state, 0, 0.0, np.random.RandomState(7))
    pmap = DM.main([*CLI, "--device", "cpu", "--resume", "last",
                    "--output-dir", str(tmp_path / "port"),
                    "--dump-json", str(tmp_path / "port.json")])

    ref, ours = (json.loads((tmp_path / f"{k}.json").read_text()) for k in ("jax", "port"))
    assert len(ours) == len(ref) > 0
    for r, j in zip(ours, ref):
        assert (r["image_id"], r["category_id"]) == (j["image_id"], j["category_id"])
        np.testing.assert_allclose(r["bbox"], j["bbox"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["score"], j["score"], rtol=1e-4, atol=1e-4)
    assert abs(pmap - jmap) <= 1e-6


EXTRA = {"maskrcnn_resnet50_fpn": "segm", "keypointrcnn_resnet50_fpn": "keypoints"}


@pytest.mark.parametrize("name", DM.MODELS)
def test_each_model_trains_an_epoch_and_evaluates(name, tmp_path, capsys):
    size = "300" if name == "ssd300_vgg16" else "64"
    cli = ["--dataset", "synthetic", "--model", name, "--small", "--image-size", size,
           "--batch-size", "4", "--max-boxes", "8", "--device", "cpu",
           "--output-dir", str(tmp_path)]
    state = DM.main([*cli, "--epochs", "1"])
    assert state.step == 4 and not any(torch.isnan(p).any() for p in state.model.parameters())
    mAP = DM.main([*cli, "--test-only", "--resume", "last"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"mAP: {mAP:.4f}" and 0.0 <= mAP <= 1.0
    if name in EXTRA:
        assert lines[1].startswith(f"{EXTRA[name]} mAP: ")
    assert len(lines) == 1 + (name in EXTRA)
    meta = json.loads((tmp_path / "checkpoints" / "last.meta.json").read_text())
    assert meta["epoch"] == 0 and list(meta["metrics"]) == ["mAP"]
