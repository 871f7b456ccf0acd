"""The port's analysis and sweep tools against the JAX package's on the CPU:
``analysis/compare.py`` (per-category AP tables, McNemar's test, k-means
anchors), ``analysis/telemetry.py`` (heatmaps, box drawing), ``sweep.py``
(Sobol candidates, GP-EI proposals, perturbation, ``run_sweep`` with a
fake objective: the same rows and CSV) and the four ``tools.py``
subcommands (the same printed lines and files) equal JAX's bit for bit;
``yolo_gradcam`` on the trained tiny YOLO of
``artifacts/synthetic_yolo.msgpack`` matches JAX's CAM within 1e-4; and
``make_artifacts --yolo`` at one epoch on 8 images writes a file that
``load_yolo_artifact`` reads back."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from object_detectors_tpu import sweep as JS
from object_detectors_tpu import tools as JTOOLS
from object_detectors_tpu.analysis import compare as JC
from object_detectors_tpu.analysis import gradcam as JG
from object_detectors_tpu.analysis import telemetry as JTEL
from object_detectors_tpu.data import synthetic as jsynthetic
from object_detectors_tpu.models.yolo import YoloHead as JYoloHead
from object_detectors_tpu_torch import sweep as S
from object_detectors_tpu_torch import tools as TOOLS
from object_detectors_tpu_torch.analysis import compare as C
from object_detectors_tpu_torch.analysis import gradcam as G
from object_detectors_tpu_torch.analysis import make_artifacts as MA
from object_detectors_tpu_torch.analysis import telemetry as TEL
from object_detectors_tpu_torch.models.yolo import YoloHead
from object_detectors_tpu_torch.utils.config import CONFIG_DIR
from object_detectors_tpu_torch.utils.weights import flax_yolo_to_torch
from torch_threads import share_cores  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _drop_checkpoint_files(tmp_path):
    """The checkpoints a test writes are hundreds of MB: delete them after it."""
    yield
    for path in tmp_path.rglob("*.pt"):
        path.unlink()


@pytest.fixture(scope="module")
def gt():
    return jsynthetic.make_coco_dicts(np.random.RandomState(0), 12, 96, 4)


def detections(gt, seed):
    """Jittered GT boxes with random scores, plus some misses and extras."""
    rng = np.random.RandomState(seed)
    out = []
    for a in gt["annotations"]:
        if rng.rand() < 0.2:
            continue
        x, y, w, h = a["bbox"]
        out.append({"image_id": a["image_id"], "category_id": a["category_id"],
                    "bbox": [x + rng.randn() * 3, y + rng.randn() * 3, w * (1 + 0.1 * rng.randn()),
                             h * (1 + 0.1 * rng.randn())], "score": float(rng.rand())})
    for _ in range(10):
        out.append({"image_id": int(rng.randint(1, 13)), "category_id": int(rng.randint(1, 5)),
                    "bbox": list(rng.uniform(0, 40, 4)), "score": float(rng.rand())})
    return out


def test_compare_is_jax_s(gt):
    a, b = detections(gt, 1), detections(gt, 2)
    assert C.per_category_table(gt, {"a": a, "b": b}) == JC.per_category_table(gt, {"a": a, "b": b})
    for thr in (0.0, 0.1, 0.5):
        assert C.mcnemar_disagreement(gt, a, b, score_thr=thr) == \
            JC.mcnemar_disagreement(gt, a, b, score_thr=thr)
    assert C.mcnemar_disagreement(gt, a, a) == JC.mcnemar_disagreement(gt, a, a)
    for k, size in ((9, 416), (6, 320), (3, 64)):
        assert C.kmeans_anchors(gt, k, size) == JC.kmeans_anchors(gt, k, size)


def test_telemetry_is_jax_s():
    rng = np.random.RandomState(3)
    grids, a, nc = (2, 4, 8), 3, 4
    p = sum(g * g for g in grids) * a
    dec = np.concatenate([rng.uniform(4, 60, (p, 4)), rng.rand(p, 1 + nc)], 1).astype(np.float32)
    gt_boxes = rng.uniform(10, 50, (5, 4)).astype(np.float32)
    gt_labels = rng.randint(0, nc, 5)
    calls = (("attribute_heatmap", (dec, 4, grids)), ("class_heatmap", (dec, 2, grids)),
             ("iou_heatmap", (dec, gt_boxes, grids)),
             ("performance_heatmap", (dec, gt_boxes, gt_labels, grids)))
    for name, args in calls:
        ours, ref = getattr(TEL, name)(*args), getattr(JTEL, name)(*args)
        assert len(ours) == len(ref) == 3
        for o, r in zip(ours, ref):
            assert o.dtype == r.dtype
            np.testing.assert_array_equal(o, r)
    img = rng.randn(32, 32, 3).astype(np.float32)
    np.testing.assert_array_equal(TEL.denormalize_image(img), JTEL.denormalize_image(img))
    canvas = TEL.denormalize_image(img)
    boxes, labels, scores = [[2, 3, 20, 25], [5.4, 6.6, 30, 31]], [1, 0], [0.9, 0.25]
    np.testing.assert_array_equal(
        TEL.draw_boxes(canvas, boxes, labels, scores, names=["a", "b"]),
        JTEL.draw_boxes(canvas, boxes, labels, scores, names=["a", "b"]))


# -- sweep -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def space():
    assert S.load_space(CONFIG_DIR) == JS.load_space(CONFIG_DIR)
    return S.load_space(CONFIG_DIR)


def test_sweep_proposers_are_jax_s(space):
    cands = S.sobol_candidates(space, 12, seed=3)
    assert cands == JS.sobol_candidates(space, 12, seed=3)
    for c in cands:
        np.testing.assert_array_equal(S._encode(space["params"], c),
                                      JS._encode(space["params"], c))
    for scale in (0.05, 0.15, 0.5):
        assert (S.perturb(cands[0], space, np.random.RandomState(1), scale)
                == JS.perturb(cands[0], space, np.random.RandomState(1), scale))
    scores = np.random.RandomState(2).randn(len(cands)).tolist()
    scores[4] = -1e7  # a failed trial
    history = [{"params": c, "score": s} for c, s in zip(cands, scores)]
    assert (S.gp_propose(history, space, np.random.RandomState(5), pool=64)
            == JS.gp_propose(history, space, np.random.RandomState(5), pool=64))
    x = np.linspace(-3, 3, 13)
    np.testing.assert_array_equal(S._erf(x), JS._erf(x))


def fake_objective(cfg):
    y = cfg.yolo
    return -(float(y.lambda_xy) - 2.0) ** 2 - abs(float(y.alpha) - 0.4) + 0.1 * int(y.iou_type)


@pytest.mark.parametrize("proposer", ["gp", "sobol", "perturb"])
def test_run_sweep_is_jax_s(tmp_path, proposer):
    kw = dict(max_trials=8, proposer=proposer, n_init=4, objective=fake_objective)
    ours = S.run_sweep(CONFIG_DIR, ["dataset=synthetic"], out_csv=str(tmp_path / "p.csv"), **kw)
    ref = JS.run_sweep(CONFIG_DIR, ["dataset=synthetic"], out_csv=str(tmp_path / "j.csv"), **kw)
    assert ours == ref
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


# -- tools -----------------------------------------------------------------------------

def test_tools_print_and_write_as_jax(gt, tmp_path, capsys):
    ann = tmp_path / "gt.json"
    ann.write_text(json.dumps(gt))
    dets = {}
    for name, seed in (("a", 1), ("b", 2)):
        dets[name] = tmp_path / f"{name}.json"
        dets[name].write_text(json.dumps(detections(gt, seed)))
    runs = [
        (["get-idf", str(ann), "{out}"], ["idf.csv"]),
        (["kmeans-anchors", str(ann)], []),
        (["kmeans-anchors", str(ann), "--num-anchors", "6", "--img-size", "320"], []),
        (["compare-maps", str(ann), f"a={dets['a']}", f"b={dets['b']}"], []),
        (["compare-maps", str(ann), f"a={dets['a']}", "--csv", "{out}/cmp.csv"], ["cmp.csv"]),
        (["disagreement", str(ann), str(dets["a"]), str(dets["b"])], []),
    ]
    for argv, files in runs:
        printed = {}
        for pkg, main in (("port", TOOLS.main), ("jax", JTOOLS.main)):
            out = tmp_path / pkg
            out.mkdir(exist_ok=True)
            main([a.replace("{out}", str(out)) for a in argv])
            printed[pkg] = capsys.readouterr().out.replace(str(out), "{out}")
        assert printed["port"] == printed["jax"] and printed["port"], argv
        for f in files:
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


# -- Grad-CAM and the artifacts ------------------------------------------------------------

def test_gradcam_matches_jax():
    with open(ROOT / "artifacts" / "synthetic_yolo.msgpack", "rb") as f:
        v = serialization.msgpack_restore(f.read())
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    model = YoloHead(4, backbone_layers=(1, 1, 1, 1, 1))
    model.load_state_dict(flax_yolo_to_torch(v["params"], v["batch_stats"]))
    jmodel = JYoloHead(num_classes=4, backbone_layers=(1, 1, 1, 1, 1))
    image = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    peaks = []
    for class_id, scale in ((0, 0), (1, 0), (2, 1), (3, 2)):
        cam = G.yolo_gradcam(model, image, class_id, scale)
        ref = JG.yolo_gradcam(jmodel, variables, jnp.asarray(image), class_id, scale)
        assert cam.shape == ref.shape == (2, 2)
        np.testing.assert_allclose(cam, ref, rtol=0, atol=1e-4)
        peaks.append(cam.max())
    assert max(peaks) == 1.0  # not every CAM is zero after its ReLU


def test_make_artifacts_yolo_round_trips(tmp_path, monkeypatch):
    monkeypatch.setattr(MA, "ARTIFACTS", str(tmp_path))
    MA.main(["--yolo", "--epochs", "1", "--device", "cpu", "dataset.num_images=8",
             "precision=f32", "dataset.canvas_size=96"])
    model, meta = MA.load_yolo_artifact("cpu")
    assert isinstance(model, YoloHead)
    assert meta["img_size"] == 64 and meta["num_classes"] == 4 and np.isfinite(meta["best_map"])
    assert "epochs=1" in meta["overrides"]
    saved = torch.load(tmp_path / "synthetic_yolo.pt", weights_only=True)
    for k, t in model.state_dict().items():
        assert torch.equal(t, saved[k]), k
    (tmp_path / "synthetic_yolo.pt").write_bytes(b"not a checkpoint")
    assert MA.load_yolo_artifact("cpu") == (None, None)
