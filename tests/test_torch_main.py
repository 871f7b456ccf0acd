"""The port's YOLO CLI (object_detectors_tpu_torch/main.py) against the JAX
package's ``main.py`` on the CPU, in float32 on both sides.

* ``build_loss_config``, ``build_model`` (its parameters and activation
  dtype) and ``build_tfidf`` at every tf-idf variant (on the JAX package's
  own test GT for them: 20 synthetic images, seed 0) equal JAX's;
  ``build_dataset`` yields the same images and GT;
* the slice as a whole: JAX's ``test_one_epoch`` on the trained tiny YOLO of
  ``artifacts/synthetic_yolo.msgpack`` (64 px, separated scores) against the
  port's ``main(["evaluate", ..., "--checkpoint", "best", "--dump-json",
  p])`` on a port checkpoint of the same weights (``flax_yolo_to_torch``),
  with ``dataset.device_preprocess`` off and on: the detections JSON equal
  (image and category ids exact, boxes within 1e-3 px at 96 px and scores
  within 1e-5, as ``tests/test_torch_protocol.py``), mAP within 1e-6;
* ``valid_one_epoch``'s loss within rtol 1e-5 and the first step of
  ``train_one_epoch`` (the device-ingest step) within rtol 1e-4, the
  tolerances of ``tests/test_torch_train.py`` and
  ``tests/test_torch_ingest.py``;
* a one-epoch ``train`` from the CLI writes the progress CSV, the
  checkpoints and their sidecars; a NaN loss returns the abort value."""

import csv
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from object_detectors_tpu import main as JM
from object_detectors_tpu.data import synthetic as jsynthetic
from object_detectors_tpu.parallel import mesh as jmesh
from object_detectors_tpu.train import trainer as JT
from object_detectors_tpu.utils import logging as jlog
from object_detectors_tpu_torch import main as M
from object_detectors_tpu_torch.train import checkpoint as ckpt
from object_detectors_tpu_torch.train import trainer
from object_detectors_tpu_torch.utils.weights import flax_yolo_to_torch
from torch_threads import share_cores  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "artifacts" / "synthetic_yolo.msgpack"
# the artifact's model: tiny Darknet, 4 classes, 64 px
BASE = ["dataset=synthetic", "backbone=tiny", "precision=f32", "dataset.canvas_size=96"]


@pytest.fixture(autouse=True)
def _drop_checkpoint_files(tmp_path):
    """The checkpoints a test writes are hundreds of MB: delete them after it."""
    yield
    for path in tmp_path.rglob("*.pt"):
        path.unlink()


def _cfgs(overrides):
    return (JM.load_config(M.CONFIG_DIR, BASE + overrides),
            M.load_config(M.CONFIG_DIR, BASE + overrides + ["device=cpu"]))


@pytest.fixture(scope="module")
def variables():
    with open(ARTIFACT, "rb") as f:
        v = serialization.msgpack_restore(f.read())
    return {"params": v["params"], "batch_stats": v["batch_stats"]}


def jax_state(cfg, variables):
    """A JAX TrainState of the configured model holding the artifact's
    variables (SGD at lr 1e-3, no schedule)."""
    tx = JM.optim_lib.make_optimizer(JM.optim_lib.OptimizerConfig(lr=1e-3),
                                     JM.optim_lib.SchedulerConfig(), 1)
    as_jax = jax.tree_util.tree_map(jnp.asarray, variables)
    return JT.TrainState.create(apply_fn=JM.build_model(cfg).apply, tx=tx, **as_jax)


def port_model(cfg, variables):
    model = M.build_model(cfg)
    model.load_state_dict(flax_yolo_to_torch(variables["params"], variables["batch_stats"]))
    return model


# -- the build_* functions -------------------------------------------------------

@pytest.fixture(scope="module")
def gt():
    return jsynthetic.make_coco_dicts(np.random.RandomState(0), 20, 96, 4)


@pytest.mark.parametrize("tfidf", [[0, 0], [0, 1], [1, 0], [1, 1], [2, 0], [2, 1]])
@pytest.mark.parametrize("extra", [[], ["yolo.tfidf_norm=1"], ["yolo.tfidf_norm=2"],
                                   ["yolo.class_loss=2", "yolo.tfidf_variant=raw"]])
def test_build_tfidf_is_jax_s(gt, tfidf, extra):
    jcfg, cfg = _cfgs([f"yolo.tfidf={tfidf}"] + extra)
    ours, ref = M.build_tfidf(cfg, gt), JM.build_tfidf(jcfg, gt)
    for o, r in zip(ours, ref):
        assert (o is None) == (r is None)
        if isinstance(r, float):
            assert o == r
        elif r is not None:
            assert o.dtype == torch.float32
            if tfidf[0] == 2 and o is ours[0]:  # effective-number weights: torch vs XLA pow
                np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
            else:
                np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("overrides", [[], ["neck.spp=true", "neck.fpn=true", "yolo.iou_type=3",
                                            "precision=bf16", "dataset=coco"]])
def test_loss_config_and_model_are_jax_s(overrides):
    jcfg, cfg = _cfgs(overrides)
    assert dataclasses.asdict(M.build_loss_config(cfg)) == \
        dataclasses.asdict(JM.build_loss_config(jcfg))
    jmodel, model = JM.build_model(jcfg), M.build_model(cfg)
    assert str(model.dtype).split(".")[-1] == jnp.dtype(jmodel.dtype).name
    size = int(jcfg.yolo.img_size)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                jnp.zeros((1, size, size, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ref = flax_yolo_to_torch(zeros["params"], zeros["batch_stats"])
    ours = model.state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: tuple(v.shape)
                                                            for k, v in ref.items()}
    assert M.label_map_for(cfg)(5) == JM.label_map_for(jcfg)(5)


@pytest.mark.parametrize("split", ["train", "val"])
def test_build_dataset_is_jax_s(split):
    jcfg, cfg = _cfgs(["dataset.num_images=6"])
    (ds, g), (jds, jg) = M.build_dataset(cfg, split), JM.build_dataset(jcfg, split)
    assert g == jg and len(ds) == len(jds) == 6
    for i in range(len(ds)):
        (img, tgt), (jimg, jtgt) = ds[i], jds[i]
        np.testing.assert_array_equal(img, jimg)
        assert tgt.keys() == jtgt.keys()
        for k in tgt:
            np.testing.assert_array_equal(tgt[k], jtgt[k], err_msg=k)


# -- the slice as a whole -------------------------------------------------------------

EVAL = ["dataset.num_images=16", "dataset.ts_batch_size=8", "metric=mAP"]


@pytest.fixture(scope="module", params=[False, True], ids=["host", "device_preprocess"])
def evaluated(request, variables, tmp_path_factory):
    """JAX's test_one_epoch (one jitted decode + NMS) and the port's
    ``main evaluate`` of the same weights, with their detections JSON."""
    out = tmp_path_factory.mktemp("eval")
    ov = EVAL + [f"dataset.device_preprocess={str(request.param).lower()}",
                 f"output_dir={out}"]
    jcfg, cfg = _cfgs(ov)
    val_ds, gt_val = JM.build_dataset(jcfg, "val")
    _, gt_train = JM.build_dataset(jcfg, "train")
    _, idf_logits, _ = JM.build_tfidf(jcfg, gt_train)
    jmap, jev = JM.test_one_epoch(jax_state(jcfg, variables), jcfg, JM.build_loss_config(jcfg),
                                  val_ds, gt_val, None, idf_logits=idf_logits)
    jev.save_detections(str(out / "jax.json"))

    state = trainer.create_yolo_train_state(port_model(cfg, variables), M._optimizer(cfg, 1))
    ckpt.CheckpointManager(str(out / "checkpoints")).save("best", state, 0, {"metric": 0.0})
    pmap = M.main(["evaluate", *BASE, *ov, "device=cpu", "--checkpoint", "best",
                   "--dump-json", str(out / "port.json")])
    (out / "checkpoints" / "best.pt").unlink()
    return jmap, pmap, [json.loads((out / f"{k}.json").read_text()) for k in ("jax", "port")]


def test_evaluate_matches_jax_test_one_epoch(evaluated):
    jmap, pmap, (ref, ours) = evaluated
    assert len(ours) == len(ref) > 0
    for r, j in zip(ours, ref):
        assert (r["image_id"], r["category_id"]) == (j["image_id"], j["category_id"])
        np.testing.assert_allclose(r["bbox"], j["bbox"], rtol=0, atol=1e-3 * 96 / 64)
        np.testing.assert_allclose(r["score"], j["score"], rtol=0, atol=1e-5)
    assert abs(pmap - jmap) <= 1e-6 and pmap > 0


# -- training and validation epochs ---------------------------------------------------

TRAIN = ["dataset.num_images=4", "dataset.tr_batch_size=4", "dataset.ts_batch_size=4",
         "multiscaler.multi_scale=false"]


def test_valid_one_epoch_is_jax_s(variables):
    jcfg, cfg = _cfgs(TRAIN + ["dataset.num_images=8"])
    ds, _ = M.build_dataset(cfg, "val")
    jds, _ = JM.build_dataset(jcfg, "val")
    ref = JM.valid_one_epoch(jax_state(jcfg, variables), jcfg, JM.build_loss_config(jcfg), jds,
                             None)
    state = trainer.create_yolo_train_state(port_model(cfg, variables), M._optimizer(cfg, 1))
    ours = M.valid_one_epoch(state, cfg, M.build_loss_config(cfg), ds)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def test_first_step_of_train_one_epoch_is_jax_s(variables):
    """One epoch of one batch: its means are the first step's losses and
    stats, before any update (the device-ingest step on both sides)."""
    jcfg, cfg = _cfgs(TRAIN)
    jds, jgt = JM.build_dataset(jcfg, "train")
    jcw, jil, _ = JM.build_tfidf(jcfg, jgt)
    one = jmesh.make_mesh(devices=jax.devices()[:1])
    _, jsub, jstats = JM.train_one_epoch(jax_state(jcfg, variables), jcfg,
                                         JM.build_loss_config(jcfg), jds, one, 0, jcw, jil)

    ds, g = M.build_dataset(cfg, "train")
    cw, il, _ = M.build_tfidf(cfg, g)
    state = trainer.create_yolo_train_state(port_model(cfg, variables), M._optimizer(cfg, 1))
    state, sub, stats = M.train_one_epoch(state, cfg, M.build_loss_config(cfg), ds, 0, cw, il)
    assert state.step == 1
    np.testing.assert_allclose(sub, jsub, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(stats, jstats, rtol=1e-4, atol=1e-6)


def test_train_cli_writes_progress_and_checkpoints(tmp_path):
    out = tmp_path / "run"
    state, best = M.main(["train", *BASE, *TRAIN, "epochs=1", "metric=mAP", "device=cpu",
                          f"output_dir={out}"])
    with open(out / "progress" / "progress.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == jlog.PROGRESS_COLUMNS and len(rows) == 2 and rows[1][0] == "0"
    assert float(rows[1][-1]) == best
    for tag in ("last", "best"):
        assert (out / "checkpoints" / f"{tag}.pt").exists()
        meta = json.loads((out / "checkpoints" / f"{tag}.meta.json").read_text())
        assert meta == {"epoch": 0, "metrics": {"metric": best}}
    assert state.step == 1 and (out / "main.log").exists()


def test_nan_loss_returns_the_abort_value():
    _, cfg = _cfgs(TRAIN)
    model = M.build_model(cfg)
    with torch.no_grad():
        model.embedding0.conv_out.bias.fill_(float("nan"))
    state = trainer.create_yolo_train_state(model, M._optimizer(cfg, 1))
    ds, _ = M.build_dataset(cfg, "train")
    out = M.train_one_epoch(state, cfg, M.build_loss_config(cfg), ds, 0, None, 1.0)
    assert out[0] is state and out[1:] == (None, None)
