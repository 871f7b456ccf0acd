"""The slice as a whole on the CPU: the JAX protocol's trained branch
(bench.py:468-489; synthetic COCO set -> CocoDetectionDataset ->
yolo_batches -> YOLO pipeline -> nms_majority -> DetectionEvaluator ->
COCOEvalNP) through both packages with the same trained weights, and the
port's ``bench.run_protocol``.

The trained tiny YOLO of ``artifacts/synthetic_yolo.msgpack`` (4 classes,
64 px, backbone (1, 1, 1, 1, 1)) is carried over with the JAX package's
loader and ``flax_yolo_to_torch``; its renderable set is cut to 16 images
at batch 8. In f32: the host batches bitwise equal, the ``nms_majority``
kept sets (valid slots and their labels) identical, boxes within 1e-3 px
and scores within 1e-5 (XLA and PyTorch sum the convolutions in other
orders), the evaluators' result lists identical in image ids and
categories, the 12 stats within 1e-6, and mAP above 0."""

import csv
import inspect
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# bench.py points JAX's persistent compile cache into the repository when
# imported; put the setting back so that the tests write nothing there.
_saved = {k: getattr(jax.config, k) for k in (
    "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
import bench as jax_bench  # noqa: E402

for _k, _v in _saved.items():
    jax.config.update(_k, _v)

from object_detectors_tpu.analysis.make_artifacts import load_yolo_artifact  # noqa: E402
from object_detectors_tpu.data import coco as JD
from object_detectors_tpu.eval import evaluator as JE
from object_detectors_tpu_torch import bench as B
from object_detectors_tpu_torch.data import coco as D
from object_detectors_tpu_torch.data import synthetic
from object_detectors_tpu_torch.eval import evaluator as E
from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
from object_detectors_tpu_torch.pipeline import build_pipeline
from object_detectors_tpu_torch.utils.weights import flax_yolo_to_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
NUM_IMAGES, BATCH = 16, 8


@pytest.fixture(scope="module")
def trained():
    variables, meta = load_yolo_artifact()
    assert variables is not None, "artifacts/synthetic_yolo.msgpack did not load"
    model = YoloHead(meta["num_classes"], 3, tuple(meta["backbone_layers"]))
    model.load_state_dict(flax_yolo_to_torch(variables["params"],
                                             variables.get("batch_stats", {})))
    return variables, meta, model


def test_trained_protocol_branch_matches_jax(trained):
    variables, meta, model = trained
    nc, img = meta["num_classes"], meta["img_size"]
    gt, loader = synthetic.renderable_dataset(np.random.RandomState(1), num_images=NUM_IMAGES,
                                              img_size=96, num_classes=nc)
    kw = dict(num_classes=nc, img_size=img, topk=64, max_det=20)
    jinfer = jax_bench.build_pipeline(**kw, variables=variables,
                                      backbone_layers=tuple(meta["backbone_layers"]),
                                      dtype=jnp.float32)
    pipe = build_pipeline(**kw, model=model, dtype=torch.float32, device="cpu")
    ours = E.DetectionEvaluator(gt, label_map=lambda c: c + 1)
    ref = JE.DetectionEvaluator(gt, label_map=lambda c: c + 1)
    batches = zip(D.yolo_batches(D.CocoDetectionDataset(gt, label_mode="lvis0",
                                                        image_loader=loader),
                                 BATCH, img, max_boxes=8),
                  JD.yolo_batches(JD.CocoDetectionDataset(gt, label_mode="lvis0",
                                                          image_loader=loader),
                                  BATCH, img, max_boxes=8))
    kept = 0
    for batch, jbatch in batches:
        for k, v in jbatch.items():
            np.testing.assert_array_equal(batch[k], v, err_msg=k)
        jb, js, jl, jv = (np.asarray(a) for a in jinfer(jnp.asarray(jbatch["images"])))
        b, s, lab, v = pipe(torch.from_numpy(batch["images"]))
        np.testing.assert_array_equal(v.numpy(), jv)
        np.testing.assert_array_equal(lab.numpy()[jv], jl[jv])
        np.testing.assert_allclose(b.numpy()[jv], jb[jv], rtol=0, atol=1e-3)
        np.testing.assert_allclose(s.numpy()[jv], js[jv], rtol=0, atol=1e-5)
        kept += int(jv.sum())
        keep = batch["image_ids"] >= 0
        ours.update(batch["image_ids"][keep], b[keep], s[keep], lab[keep], v[keep],
                    batch["scale_factors"][keep])
        ref.update(jbatch["image_ids"][keep], jb[keep], js[keep], jl[keep], jv[keep],
                   jbatch["scale_factors"][keep])
    assert kept > 0 and len(ours.results) == len(ref.results) == kept
    for r, j in zip(ours.results, ref.results):
        assert (r["image_id"], r["category_id"]) == (j["image_id"], j["category_id"])
        np.testing.assert_allclose(r["bbox"], j["bbox"], rtol=0, atol=1e-3 * 96 / img)
        np.testing.assert_allclose(r["score"], j["score"], rtol=0, atol=1e-5)
    stats, jstats = ours.summarize(), ref.summarize()
    np.testing.assert_allclose(stats, jstats, rtol=0, atol=1e-6)
    assert stats[0] > 0


def test_run_protocol_rows_are_the_reference_s(tmp_path):
    """A seeded tiny model through ``run_protocol`` on the CPU: the CSV has
    the columns of the JAX package's tracked benchmark_res.csv, one row a
    run."""
    model = init_yolo_(YoloHead(4, 3, (1, 1, 1, 1, 1)), seed=0)
    meta = {"img_size": 64, "num_classes": 4, "backbone_layers": [1, 1, 1, 1, 1]}
    out = tmp_path / "rows.csv"
    rows = B.run_protocol(batch_sizes=(4,), num_images=8, runs=1, out_csv=str(out),
                          device="cpu", model=model, meta=meta)
    with open(ROOT / "benchmark_res.csv") as f:
        reference_keys = next(csv.reader(f))
    with open(out) as f:
        written = list(csv.DictReader(f))
    assert list(written[0]) == reference_keys == list(B.PROTOCOL_FIELDS)
    assert len(rows) == len(written) == 1 and rows[0]["batch"] == 4
    assert set(rows[0]) == set(reference_keys) | {"detections", "img_size"}
    assert rows[0]["img_size"] == meta["img_size"]
    assert rows[0]["detections"] >= 0 and 0.0 <= rows[0]["map"] <= 1.0
    assert rows[0]["app_time"] >= rows[0]["forw_time"] + rows[0]["cpu_time"] - 1e-3


def test_protocol_writes_under_output_by_default():
    default = inspect.signature(B.run_protocol).parameters["out_csv"].default
    assert pathlib.Path(default).parent == ROOT / "output"
    assert "output/" in (ROOT / ".gitignore").read_text().split()


@pytest.mark.parametrize("with_artifact", [True, False], ids=["trained", "seeded"])
def test_bench_protocol_scores_the_trained_artifact(tmp_path, monkeypatch, capsys,
                                                    with_artifact):
    """``bench --protocol`` hands ``run_protocol`` the artifact of
    ``make_artifacts`` (model and meta) when one is present, as the root
    bench does, and nothing otherwise; its line says which weights it
    scored. ``run_protocol`` is replaced by a recorder."""
    from object_detectors_tpu_torch.analysis import make_artifacts as MA

    monkeypatch.setattr(MA, "ARTIFACTS", str(tmp_path))
    meta = {"model": "yolo_tiny", "num_classes": 4, "img_size": 64,
            "backbone_layers": [1, 1, 1, 1, 1]}
    saved = init_yolo_(YoloHead(4, 3, (1, 1, 1, 1, 1)), seed=5)
    if with_artifact:
        MA._save(str(tmp_path / "synthetic_yolo.pt"), saved.state_dict(), meta)
    got = {}

    def recorder(batch_sizes, **kwargs):
        got.update(kwargs, batch_sizes=batch_sizes)
        return [{"batch": 2, "map": 0.5}]

    monkeypatch.setattr(B, "run_protocol", recorder)
    B.main(["--protocol", "--device", "cpu", "--batch-sizes", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["batch_sizes"] == (2,) and str(got["device"]) == "cpu"
    assert line["value"] == 0.5 and line["card"] == "none"
    if with_artifact:
        assert line["weights"] == "trained" and got["meta"] == meta
        assert isinstance(got["model"], YoloHead)
        for k, v in saved.state_dict().items():
            assert torch.equal(got["model"].state_dict()[k], v), k
    else:
        assert line["weights"] == "seeded"
        assert got["model"] is None and got["meta"] is None
