"""The port's bench (object_detectors_tpu_torch/bench.py) against the root
bench.py: its timing loop, the configuration of each row, the output line's
keys, and the three NMS candidate generators, on the CPU with fake
pipelines where a row would run a full-width model."""

import json
import sys

import numpy as np
import pytest
import torch

from object_detectors_tpu_torch import bench as B
from test_torch_pipeline import bench as ref_bench

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def test_timed_stream_cycles_distinct_batches():
    seen = []

    def infer(batch):
        seen.append(int(batch[0, 0]))
        return batch, batch.float().sum(1)

    batches = [np.full((2, 3), v, np.uint8) for v in (7, 8, 9)]
    dt = B._timed_stream(infer, batches, warmup=2, iters=5, device="cpu")
    assert dt > 0
    assert seen == [7, 8] + [7, 8, 9, 7, 8]  # warm-up, then the timed calls


def _reference_nms_generators(bs, n_cand):
    """The generators of the root bench.py's run_nms_latency, copied as
    they are."""
    def uniform(rng):
        xy = rng.rand(bs, n_cand, 2) * 600
        wh = rng.rand(bs, n_cand, 2) * 120 + 1
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    def clustered(rng):
        centers = rng.rand(bs, 12, 2) * 560 + 40
        assign = rng.randint(0, 12, (bs, n_cand))
        cxy = np.take_along_axis(centers, assign[..., None], axis=1)
        jitter = rng.randn(bs, n_cand, 2) * 10
        wh = rng.rand(bs, n_cand, 2) * 40 + 40
        xy = cxy + jitter - wh / 2
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    def adversarial(rng):
        x = np.arange(n_cand, dtype=np.float32) * 2.0
        one = np.stack([x, np.zeros_like(x), x + 10,
                        np.full_like(x, 10.0)], -1)
        boxes = np.tile(one[None], (bs, 1, 1))
        scores = np.tile(np.linspace(1.0, 0.5, n_cand,
                                     dtype=np.float32)[None], (bs, 1))
        return boxes, scores

    return (("uniform", uniform), ("clustered", clustered), ("adversarial", adversarial))


@pytest.mark.parametrize("bs,n_cand", [(512, 256), (3, 40)])
def test_nms_generators_equal_the_reference(bs, n_cand):
    for name, gen in _reference_nms_generators(bs, n_cand):
        rng = np.random.RandomState(5)
        out_gen = gen(rng)
        if isinstance(out_gen, tuple):
            boxes_np, scores_np = out_gen
        else:
            boxes_np = out_gen
            scores_np = rng.rand(bs, n_cand).astype(np.float32)
        labels = rng.randint(0, 80, (bs, n_cand))
        for got, want in zip(B.nms_inputs(name, bs, n_cand, 80), (boxes_np, scores_np, labels)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_nms_latency_row_on_cpu():
    res = B.run_nms_latency(bs=4, n_cand=32, iters=2, device="cpu")
    assert list(res) == ["uniform", "clustered", "adversarial"]
    for v in res.values():
        assert set(v) == {"p50_us", "max_mean_us"} and 0 < v["p50_us"] <= v["max_mean_us"]


def test_rows_build_the_reference_configurations(monkeypatch):
    """Seeds, batches, image sizes and graph settings of the three rows
    that are one pipeline each."""
    built, rows = [], []
    for name in ("build_pipeline_uint8", "build_frcnn_pipeline_uint8"):
        monkeypatch.setattr(B, name, lambda *a, _n=name, **k: built.append((_n, a, k)) or _n)
    monkeypatch.setattr(B.S, "build_retinanet_pipeline",
                        lambda *a, **k: built.append(("retinanet", a, k)) or "retinanet")
    monkeypatch.setattr(B, "_run_row", lambda *a: rows.append(a) or (1.0, None))
    B.run_retinanet(), B.run_frcnn(), B.run_yolo_lvis()
    assert built == [("retinanet", (), dict(img_size=640, uint8_input=True, device="cuda")),
                     ("build_frcnn_pipeline_uint8", (), dict(img_size=640, device="cuda")),
                     ("build_pipeline_uint8", (1203, 416), dict(topk=300, max_det=300,
                                                                device="cuda"))]
    # (pipeline, seed, batch, image size, warm-up, timed calls, device)
    assert [r[1:] for r in rows] == [(1, 16, 640, 2, 8, "cuda"), (2, 16, 640, 2, 8, "cuda"),
                                     (3, 16, 416, 2, 8, "cuda")]


def _fake_detector(images):
    b = images.shape[0]
    return (torch.zeros(b, 5, 4), images.reshape(b, -1)[:, :5].float(),
            torch.zeros(b, 5, dtype=torch.int32), torch.ones(b, 5, dtype=torch.bool))


def test_serving_row_on_cpu():
    """The mixed stream at 4:1 with flushes of 4 and 2 over fake pipelines:
    every request answered once, by its own model, from its pool slot."""
    ips, out, server = B.run_serving(n_requests=20, img_size=8, yolo_bs=4, retina_bs=2,
                                     device="cpu",
                                     pipelines={"yolo": _fake_detector,
                                                "retinanet": _fake_detector})
    assert ips > 0 and sorted(r.request_id for r in out) == list(range(20))
    pool = server.pool.reshape(32, -1)[:, :5].float().numpy()
    for r in out:
        assert r.model == ("yolo" if r.request_id % 5 else "retinanet")
        np.testing.assert_array_equal(r.scores, pool[r.request_id % 32])
    assert server.flushes["yolo"] >= 4 and server.flushes["retinanet"] >= 2
    assert server.pool.dtype == torch.uint8 and server.input_dtype == torch.uint8


def _main_line(monkeypatch, capsys, module, argv, fakes):
    for name, fake in fakes.items():
        monkeypatch.setattr(module, name, fake)
    monkeypatch.setattr(sys, "argv", ["bench.py"] + argv)
    module.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


NMS_RES = {d: {"p50_us": 1.0, "max_mean_us": 2.0}
           for d in ("uniform", "clustered", "adversarial")}
ROW_FAKES = dict(run=lambda *a, **k: (10.0, {128: 10.0}, 0.5),
                 run_retinanet=lambda: (1.0, 0.1), run_frcnn=lambda: (2.0, 0.2),
                 run_yolo_lvis=lambda: (3.0, 0.3), run_nms_latency=lambda: NMS_RES)


@pytest.mark.parametrize("argv", [[], ["--quick"], ["--configs", "frcnn640", "serving"]])
def test_main_prints_the_reference_line_without_vs_baseline(monkeypatch, capsys, argv):
    ref = _main_line(monkeypatch, capsys, ref_bench, argv,
                     dict(ROW_FAKES, run_train_step=lambda: (4.0, 0.4),
                          run_serving=lambda: 5.0))
    out = _main_line(monkeypatch, capsys, B, argv,
                     dict(ROW_FAKES, card_line=lambda: CARD, run_train_step=lambda: (4.0, 0.4),
                          run_serving=lambda: (5.0, [], None)))
    assert set(out) == set(ref) - {"vs_baseline"} | {"card"} and out["card"] == CARD
    assert list(out["configs"]) == list(ref["configs"])
    for name, row in ref["configs"].items():
        assert set(out["configs"][name]) == set(row) - {"vs_baseline"} | {"card"}
        assert out["configs"][name]["card"] == CARD
        assert out["configs"][name]["value"] == pytest.approx(row["value"])
    if "nms_p50_latency" in out["configs"]:
        assert out["configs"]["nms_p50_latency"]["distributions"] == NMS_RES
    assert out["metric"] == ref["metric"] and out["unit"] == ref["unit"]


def test_a_failing_row_raises(monkeypatch, capsys):
    def broken():
        raise RuntimeError("serving broke")

    with pytest.raises(RuntimeError, match="serving broke"):
        _main_line(monkeypatch, capsys, B, [],
                   dict(ROW_FAKES, card_line=lambda: CARD, run_train_step=lambda: (4.0, 0.4),
                        run_serving=broken))
    assert capsys.readouterr().out == ""


def test_train_row_builds_the_reference_batches():
    """yolo_train416's batches are the root bench's run_train_step draws."""
    rng = np.random.RandomState(3)
    for got in B.train_batches(2, 32):
        want = dict(images=rng.rand(2, 32, 32, 3).astype(np.float32),
                    gt_boxes=rng.rand(2, 32, 4).astype(np.float32) * 0.5 + 0.25,
                    gt_labels=rng.randint(0, 80, (2, 32)), gt_valid=rng.rand(2, 32) < 0.5)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)


def test_train_row_on_cpu():
    """The timed train steps of a tiny YOLO at 64 px: readings present, the
    model's parameters moved by the steps."""
    from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_

    model = init_yolo_(YoloHead(80, backbone_layers=(1, 1, 1, 1, 1), dtype=torch.bfloat16))
    before = model.backbone.stem.conv.weight.detach().clone()
    t = B.train_step_timing(bs=2, img_size=64, warmup=1, iters=2, device="cpu", model=model)
    assert t["imgs_per_s"] > 0 and t["ms_per_step"] > 0 and t["max_memory_gb"] is None
    assert np.isfinite(t["loss"]) and t["mfu"] > 0
    assert not torch.equal(before, model.backbone.stem.conv.weight)
