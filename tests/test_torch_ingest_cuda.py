"""The data and eval slice on the GPU: the two canvas resizes of
object_detectors_tpu_torch/kernels/preprocess.py on the card against the
CPU port, one batch of the bench's protocol on the card, and the native
COCO matcher (csrc/coco_eval_core.cpp) built there. Imports no JAX, so
that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_ingest_cuda.py

Tolerances: f32 within 1e-5 rtol/atol (the same f32 sampling matrices;
cuBLAS sums the products in another order than the CPU, TF32 off); bf16
within one bf16 ulp of max(|cpu|, 1) (one rounding of those f32 values)."""

import numpy as np
import pytest
import torch

from object_detectors_tpu_torch.kernels import nms as KN
from object_detectors_tpu_torch.kernels import preprocess as P

BF16_ULP = 2.0 ** -7


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the test holds the card against the CPU")


def _canvas(seed, b, size):
    rng = np.random.RandomState(seed)
    canvas = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    sizes = np.stack([rng.randint(size // 3, size + 1, b),
                      rng.randint(size // 3, size + 1, b)], 1).astype(np.int32)
    sizes[0] = size
    return torch.from_numpy(canvas), torch.from_numpy(sizes)


def _close(gpu, cpu, dtype):
    gpu = gpu.cpu().float()
    cpu = cpu.float()
    if dtype == torch.float32:
        torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-5)
    else:
        assert ((gpu - cpu).abs() <= BF16_ULP * cpu.abs().clamp(min=1.0)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,size,out_dim", [(4, 640, 416), (3, 96, 64), (2, 200, 320)])
def test_yolo_canvas_resize_on_the_card_is_the_cpu_s(b, size, out_dim, dtype):
    _card()
    canvas, sizes = _canvas(b + size, b, size)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gpu = P.resize_normalize_from_canvas(canvas.cuda(), sizes.cuda(), out_dim, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    _close(gpu, P.resize_normalize_from_canvas(canvas, sizes, out_dim, dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("b,size,out_hw", [(2, 640, (800, 800)), (3, 96, (64, 96))])
def test_rcnn_canvas_resize_on_the_card_is_the_cpu_s(b, size, out_hw, per_image):
    _card()
    canvas, sizes = _canvas(b * size, b, size)
    min_sizes = torch.tensor([out_hw[0] * 0.6, out_hw[0] * 0.8, out_hw[0]][:b]) \
        if per_image else None
    kw = dict(min_size=out_hw[0], max_size=int(out_hw[1] * 1.6), min_sizes=min_sizes)
    gpu = P.rcnn_resize_normalize_from_canvas(canvas.cuda(), sizes.cuda(), out_hw, **kw)
    cpu = P.rcnn_resize_normalize_from_canvas(canvas, sizes, out_hw, **kw)
    _close(gpu[0], cpu[0], torch.float32)
    assert torch.equal(gpu[1].cpu(), cpu[1]) and torch.equal(gpu[2].cpu(), cpu[2])


@pytest.mark.cuda
def test_one_protocol_batch_on_the_card(tmp_path):
    """Full-width YOLOv3 at 416², 8 seeded images, one run: one NMS launch
    a pipeline call (the warm-up and the batch), a row with finite times."""
    _card()
    from object_detectors_tpu_torch import bench as B

    before = KN.launches
    rows = B.run_protocol(batch_sizes=(8,), num_images=8, runs=1,
                          out_csv=str(tmp_path / "rows.csv"))
    assert KN.launches - before == 2
    assert len(rows) == 1 and rows[0]["batch"] == 8
    assert all(np.isfinite(rows[0][k]) for k in B.PROTOCOL_FIELDS)
    assert (tmp_path / "rows.csv").read_text().splitlines()[0] == ",".join(B.PROTOCOL_FIELDS)


@pytest.mark.cuda
def test_native_matcher_builds_on_the_card_machine():
    _card()
    from object_detectors_tpu_torch.data import synthetic
    from object_detectors_tpu_torch.eval import coco_map as CM
    from object_detectors_tpu_torch.eval import native as N

    N.load()
    rng = np.random.RandomState(2)
    gt = synthetic.make_coco_dicts(rng, num_images=20, num_classes=5)
    dts = [{"image_id": a["image_id"], "category_id": a["category_id"],
            "bbox": [a["bbox"][0] + rng.randn() * 3, *a["bbox"][1:]], "score": float(rng.rand())}
           for a in gt["annotations"]]
    np.testing.assert_array_equal(CM.evaluate_detections(gt, dts),
                                  CM.evaluate_detections(gt, dts, plain=True))
