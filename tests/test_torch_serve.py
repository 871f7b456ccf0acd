"""The port's batched server (object_detectors_tpu_torch/serve.py): the
semantics of tests/test_serving.py on fake torch pipelines, every request
form, and one mixed stream through the JAX server over tiny JAX YOLO and
RetinaNet pipelines against the port's server over the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu import serve as jax_serve
from object_detectors_tpu.kernels.preprocess import preprocess_images as jax_preprocess
from object_detectors_tpu.models import retinanet as JRN
from object_detectors_tpu_torch import serve as S
from object_detectors_tpu_torch.serve import BatchedDetectionServer, Request
from test_torch_pipeline import bench
from test_torch_retinanet import (
    CLS_SCALE, _anchors, _grids, _randomized_frozen, _torch_retinanet,
)
from test_torch_retinanet import LAYERS as RETINA_LAYERS
from test_torch_retinanet import NUM_CLASSES as RETINA_CLASSES
from test_torch_yolo import LAYERS, NUM_CLASSES, randomized_flax_variables, torch_model

IMG = 96


def fake_pipeline(tag: int, calls=None):
    """Each image's mean as its score, so a response shows whose image it
    got; label ``tag``; one fixed box."""
    def infer(images):
        if calls is not None:
            calls.append(tuple(images.shape))
        b = images.shape[0]
        score = images.reshape(b, -1).float().mean(1)[:, None]
        boxes = torch.tensor([[1.0, 2.0, 3.0, 4.0]]).repeat(b, 1)[:, None, :]
        labels = torch.full((b, 1), tag, dtype=torch.int32)
        return boxes, score, labels, torch.ones((b, 1), dtype=torch.bool)

    return infer


def make_req(i, model, value):
    return Request(i, model, np.full((8, 8, 3), value, np.float32))


def server(pipelines, batch_size, **kwargs):
    return BatchedDetectionServer(pipelines, batch_size, device="cpu", **kwargs)


def test_mixed_stream_demultiplexes():
    srv = server({"yolo": fake_pipeline(1), "retinanet": fake_pipeline(2)}, 4)
    reqs = [make_req(i, "yolo" if i % 2 == 0 else "retinanet", i / 10.0) for i in range(10)]
    out = srv.run_stream(reqs)
    assert len(out) == 10
    by_id = {r.request_id: r for r in out}
    for i in range(10):
        r = by_id[i]
        assert r.model == ("yolo" if i % 2 == 0 else "retinanet")
        assert r.labels[0] == (1 if i % 2 == 0 else 2)
        assert r.scores[0] == pytest.approx(i / 10.0, abs=1e-5)
        assert r.latency_s >= 0
    assert srv.flushes == {"yolo": 2, "retinanet": 2}


def test_partial_batch_flush():
    calls = []
    srv = server({"m": fake_pipeline(0, calls)}, 8)
    out = srv.run_stream([make_req(0, "m", 0.5)])
    assert len(out) == 1 and out[0].scores[0] == pytest.approx(0.5, abs=1e-5)
    assert calls == [(8, 8, 8, 3)]  # padded to the batch, the padding dropped


def test_full_batches_dispatch_eagerly_resolve_on_drain():
    srv = server({"m": fake_pipeline(0)}, 2, max_delay_s=100.0)
    responses = []
    for i in range(4):
        srv.submit(make_req(i, "m", i / 4))
        responses.extend(srv.poll())
    # both batches were dispatched (queues empty) and wait in flight
    assert all(len(q) == 0 for q in srv.queues.values())
    assert len(srv.pending) == 2 and responses == []
    responses.extend(srv.drain())
    assert sorted(r.request_id for r in responses) == [0, 1, 2, 3]


def test_inflight_bound_forces_resolution():
    srv = server({"m": fake_pipeline(0)}, 1, max_delay_s=100.0)
    srv.max_inflight = 2
    responses = []
    for i in range(6):
        srv.submit(make_req(i, "m", 0.1))
        responses.extend(srv.poll())
        assert len(srv.pending) <= 2
    assert len(responses) == 4  # 6 dispatches, at most 2 in flight
    responses.extend(srv.drain())
    assert len(responses) == 6


def test_pooled_requests_single_dispatch_per_flush():
    calls = []
    srv = server({"m": fake_pipeline(7, calls)}, 4)
    pool = np.stack([np.full((8, 8, 3), v / 10.0, np.float32) for v in range(6)])
    assert torch.equal(srv.stage_pool(pool), torch.from_numpy(pool))
    out = srv.run_stream([Request(i, "m", i % 6) for i in range(10)])
    assert len(out) == 10 and len(calls) == 3  # one pipeline call a flush
    by_id = {r.request_id: r for r in out}
    for i in range(10):
        r = by_id[i]
        assert r.labels[0] == 7 and bool(r.valid[0])
        assert r.scores[0] == pytest.approx((i % 6) / 10.0, abs=1e-5)
        np.testing.assert_allclose(r.boxes[0], [1.0, 2.0, 3.0, 4.0])


def test_request_forms_give_the_same_responses():
    """A pool slot, a tensor and a numpy array of the same image, uint8 in
    and cast by input_dtype, answer alike."""
    rng = np.random.RandomState(0)
    pool = rng.randint(0, 256, (5, 8, 8, 3)).astype(np.uint8)
    forms = {"slot": lambda i: i, "tensor": lambda i: torch.from_numpy(pool[i]),
             "numpy": lambda i: pool[i]}
    answers = {}
    for name, form in forms.items():
        srv = server({"m": fake_pipeline(3)}, 2, input_dtype=torch.float32)
        srv.stage_pool(pool)
        out = srv.run_stream([Request(i, "m", form(i % 5)) for i in range(7)])
        answers[name] = {r.request_id: (r.scores[0], r.labels[0]) for r in out}
    assert answers["slot"] == answers["tensor"] == answers["numpy"]
    assert answers["slot"][6][0] == pytest.approx(pool[1].mean(), rel=1e-6)


def test_labels_pass_the_float_pack_exactly():
    """The largest LVIS class id and RetinaNet's -1 for an invalid slot."""
    def infer(images):
        b = images.shape[0]
        labels = torch.tensor([[1202, -1, 0]], dtype=torch.int32).repeat(b, 1)
        return (torch.zeros(b, 3, 4), torch.zeros(b, 3), labels,
                torch.tensor([[True, False, True]]).repeat(b, 1))

    out = server({"m": infer}, 2).run_stream([make_req(0, "m", 0.0)])
    assert out[0].labels.tolist() == [1202, -1, 0] and out[0].labels.dtype == np.int32
    assert out[0].valid.tolist() == [True, False, True]


def test_serving_pipeline_defaults():
    pipe = S.build_yolo_pipeline(num_classes=NUM_CLASSES, img_size=64, uint8_input=True,
                                 backbone_layers=LAYERS, device="cpu")
    assert (pipe.topk, pipe.max_det, pipe.conf, pipe.iou_thr, pipe.dtype, pipe.uint8) == (
        512, 100, 0.1, 0.6, torch.bfloat16, True)
    assert S.build_yolo_pipeline.__defaults__[:6] == (80, 640, 64, torch.bfloat16, 512, 100)
    assert S.build_retinanet_pipeline.__defaults__[:4] == (91, 640, (3, 4, 6, 3),
                                                           torch.bfloat16)
    rn = S.build_retinanet_pipeline(num_classes=RETINA_CLASSES, img_size=IMG,
                                    resnet_layers=RETINA_LAYERS, device="cpu")
    assert not rn.uint8 and rn.model.dtype == torch.bfloat16
    assert rn.model.backbone.resnet.layers == RETINA_LAYERS


def test_cuda_server_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedDetectionServer({"m": fake_pipeline(0)}, 2)


@pytest.fixture(scope="module")
def tiny_pipelines():
    """(JAX pipelines, port pipelines) over the same weights: YOLOv3 on
    Darknet (1, 1, 1, 1, 1), 4 classes, top-512, and RetinaNet on ResNet
    (1, 1, 1, 1), 5 classes, both uint8 in at 96 px, in f32."""
    _, yolo_vars = randomized_flax_variables(IMG, seed=2)
    yolo_core = bench.build_pipeline(num_classes=NUM_CLASSES, img_size=IMG, topk=512,
                                     dtype=jnp.float32, variables=yolo_vars,
                                     backbone_layers=LAYERS)

    model = JRN.RetinaNet(num_classes=RETINA_CLASSES, resnet_layers=RETINA_LAYERS)
    v = jax.jit(lambda key: model.init(key, jnp.zeros((1, 32, 32, 3)), train=False))(
        jax.random.key(0))
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    v["frozen"] = _randomized_frozen(v["frozen"], 1)
    cls = v["params"]["head"]["cls_logits"]
    cls["kernel"] = cls["kernel"] * CLS_SCALE
    anchors = jnp.asarray(_anchors())
    cfg = JRN.RetinaNetConfig(num_classes=RETINA_CLASSES)

    def jax_retinanet(u8):
        cls, reg, sizes = model.apply(v, jax_preprocess(u8, jnp.float32), train=False)
        return JRN.retinanet_postprocess(cls, reg, anchors, tuple(sizes), (IMG, IMG), cfg,
                                         grids=_grids())

    jax_pipes = {"yolo": lambda u8: yolo_core(jax_preprocess(u8, jnp.float32)),
                 "retinanet": jax_retinanet}
    port_pipes = {
        "yolo": S.build_yolo_pipeline(num_classes=NUM_CLASSES, img_size=IMG,
                                      dtype=torch.float32, uint8_input=True,
                                      model=torch_model(yolo_vars), device="cpu"),
        "retinanet": S.build_retinanet_pipeline(
            num_classes=RETINA_CLASSES, img_size=IMG, resnet_layers=RETINA_LAYERS,
            dtype=torch.float32, uint8_input=True, device="cpu",
            model=_torch_retinanet(v["params"], v["frozen"])),
    }
    return jax_pipes, port_pipes


def test_stream_matches_the_jax_server(tiny_pipelines):
    """13 pooled requests, YOLO and RetinaNet at 4:1, flushes of 4 and 2
    (partial ones at the end), deadlines out of reach so both servers flush
    the same batches: per request id, labels, valid and order identical,
    boxes and scores within the tolerances of the pipeline tests."""
    jax_pipes, port_pipes = tiny_pipelines
    pool = np.random.RandomState(3).randint(0, 256, (6, IMG, IMG, 3)).astype(np.uint8)
    sizes = {"yolo": 4, "retinanet": 2}
    reqs = [("yolo" if i % 5 else "retinanet", i % 6) for i in range(13)]

    ref_server = jax_serve.BatchedDetectionServer(jax_pipes, sizes, max_delay_s=100.0,
                                                  input_dtype=jnp.uint8)
    ref_server.stage_pool(pool)
    ref = {r.request_id: r for r in ref_server.run_stream(
        [jax_serve.Request(i, m, slot) for i, (m, slot) in enumerate(reqs)])}
    port_server = BatchedDetectionServer(port_pipes, sizes, max_delay_s=100.0,
                                         input_dtype=torch.uint8, device="cpu")
    port_server.stage_pool(pool)
    out = {r.request_id: r for r in port_server.run_stream(
        [Request(i, m, slot) for i, (m, slot) in enumerate(reqs)])}

    assert sorted(out) == sorted(ref) == list(range(13))
    assert port_server.flushes == {"yolo": 3, "retinanet": 2}
    for i, (model, _) in enumerate(reqs):
        o, r = out[i], ref[i]
        assert o.model == r.model == model
        np.testing.assert_array_equal(o.valid, r.valid)
        np.testing.assert_array_equal(o.labels, r.labels)
        if model == "yolo":
            np.testing.assert_allclose(o.boxes, r.boxes, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(o.scores, r.scores, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(o.boxes, r.boxes, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(o.scores, r.scores, rtol=1e-5, atol=1e-5)
        assert o.valid.any()
