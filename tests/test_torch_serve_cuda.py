"""The batched server (object_detectors_tpu_torch/serve.py) on the card:
a flush of YOLO and of RetinaNet queues its work without a host sync, and
every response equals its row of the flush's batch run again through its
pipeline. Imports no JAX, so that it runs on a machine with a card and
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py
"""

import numpy as np
import pytest
import torch

from object_detectors_tpu_torch import serve as S
from object_detectors_tpu_torch.models.retinanet import RetinaNet, init_retinanet_
from object_detectors_tpu_torch.ops.boxes import decode_boxes

IMG = 96


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_decode_boxes_queues_without_a_host_sync():
    """The divisor of the box weights is made on the device: RetinaNet's
    cap+decode stage does not wait for the card."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    codes = torch.randn(2, 50, 4, device="cuda", generator=g)
    boxes = torch.rand(2, 50, 4, device="cuda", generator=g).sort(-1).values * 100
    decode_boxes(codes, boxes, (10.0, 10.0, 5.0, 5.0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = decode_boxes(codes, boxes, (10.0, 10.0, 5.0, 5.0))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = decode_boxes(codes.cpu(), boxes.cpu(), (10.0, 10.0, 5.0, 5.0))
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_flushes_queue_without_a_host_sync_and_answer_their_batch():
    _needs_card()
    pipelines = {
        "yolo": S.build_yolo_pipeline(num_classes=4, img_size=IMG, uint8_input=True,
                                      backbone_layers=(1, 1, 1, 1, 1)),
        "retinanet": S.build_retinanet_pipeline(
            num_classes=5, img_size=IMG, uint8_input=True,
            model=init_retinanet_(RetinaNet(5, (1, 1, 1, 1)))),
    }
    sizes = {"yolo": 4, "retinanet": 2}
    server = S.BatchedDetectionServer(pipelines, sizes, max_delay_s=100.0,
                                      input_dtype=torch.uint8)
    pool = np.random.RandomState(0).randint(0, 256, (6, IMG, IMG, 3)).astype(np.uint8)
    server.stage_pool(pool)
    server.run_stream([S.Request(i, m, i % 6) for i, m in enumerate(sizes)])  # warm-up
    for model, bs in sizes.items():
        for i in range(bs):
            server.submit(S.Request(100 + i, model, (i * 5) % 6))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            assert server._flush(model) == []
        finally:
            torch.cuda.set_sync_debug_mode("default")
        (entry,) = server.pending
        assert entry.host.is_pinned() and entry.done is not None
        out = server.drain()
        assert [r.request_id for r in out] == list(range(100, 100 + bs))
        batch = server.pool.index_select(
            0, torch.tensor([(i * 5) % 6 for i in range(bs)], device="cuda"))
        boxes, scores, labels, valid = [t.cpu().numpy() for t in pipelines[model](batch)]
        for i, r in enumerate(out):
            assert np.array_equal(r.boxes, boxes[i]) and np.array_equal(r.scores, scores[i])
            assert np.array_equal(r.labels, labels[i]) and np.array_equal(r.valid, valid[i])
