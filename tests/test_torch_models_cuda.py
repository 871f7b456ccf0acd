"""The kernels on the paths of the detection_main architectures, on the GPU:
the RoIAlign forward and backward at the mask and keypoint branches' 14x14
pooler and the NMS kernel at SSD's postprocess, each at the inputs its path
gives it, against its plain version; and one train step of each new
architecture on the GPU against the same step on the CPU. Imports no JAX,
so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_models_cuda.py

Tolerances: the RoIAlign forward and backward within 1e-4 relative and
1e-5 absolute in f32 (the same products in another order; the backward's
atomics), each RoI's level and route as ``assign_fpn_levels`` and the rules
of kernels/roi_align.py say; NMS kept sets identical. The train steps and
their tolerances are those of object_detectors_tpu_torch/train/tiny_steps.py.
"""

import contextlib

import pytest
import torch

from object_detectors_tpu_torch import detection_main as DM
from object_detectors_tpu_torch.kernels import nms as KN
from object_detectors_tpu_torch.kernels import roi_align as KR
from object_detectors_tpu_torch.kernels import roi_align_bwd as KB
from object_detectors_tpu_torch.ops.roi_align import assign_fpn_levels
from object_detectors_tpu_torch.train import tiny_steps as TS

SIZE = 256


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@contextlib.contextmanager
def watched(module, name):
    """Records the (args, kwargs) of every call of ``module.name``."""
    calls, wrapper = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return wrapper(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, wrapper)


def _adapter(name):
    """A ResNet (1, 1, 1, 1) model of ``name`` at 256² on the card with the
    full-size RPN and RoI settings (1000 proposals, 512 RoIs, 100
    detections)."""
    return DM.ModelAdapter(name, 2 if name.startswith("keypoint") else 5, SIZE,
                           resnet_layers=(1, 1, 1, 1), device="cuda", seed=1)


def _batch(name):
    size = 300 if name.startswith("ssd") else SIZE
    return {k: t.cuda() for k, t in TS.adapter_batch(name, size, seed=5).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["maskrcnn_resnet50_fpn", "keypointrcnn_resnet50_fpn"])
def test_branch_roi_align_forward_at_14x14_matches_plain(name):
    _needs_gpu()
    adapter = _adapter(name)
    images = _batch(name)["images"]
    with watched(KR, "multiscale_roi_align_cuda") as calls:
        adapter.detect(images)
    assert [c[0][3] for c in calls] == [(7, 7), (14, 14)]
    maps, boxes, size, out_size, ratio = calls[1][0]
    assert boxes.shape == (2, 100, 4) and ratio == 2
    route = torch.empty(boxes.shape[:2], dtype=torch.uint8, device="cuda")
    got = KR.multiscale_roi_align_cuda(maps, boxes, size, out_size, route=route)
    ref = KR.multiscale_roi_align_reference(maps, boxes, size, out_size)
    assert got.shape == (2, 100, 14, 14, 256)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    assert torch.equal((route // 2).int(), assign_fpn_levels(boxes, len(maps)))
    assert torch.equal((route % 2).bool(), KR.staged_rois(maps, boxes, size, out_size)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["maskrcnn_resnet50_fpn", "keypointrcnn_resnet50_fpn"])
def test_branch_roi_align_backward_at_14x14_matches_plain(name):
    _needs_gpu()
    adapter = _adapter(name)
    with watched(KB, "multiscale_roi_align_backward_cuda") as calls:
        losses = adapter.losses(_batch(name), generator=torch.Generator("cuda").manual_seed(0))
        sum(losses.values()).backward()
    assert sorted(c[0][4] for c in calls) == [(7, 7), (14, 14)]
    cot, boxes, shapes, size, out_size, ratio, *rest = next(
        c[0] for c in calls if c[0][4] == (14, 14))
    assert cot.shape == (2, 512, 14, 14, 256) and cot.dtype == torch.float32
    route = torch.empty(boxes.shape[:2], dtype=torch.uint8, device="cuda")
    got = KB.multiscale_roi_align_backward_cuda(cot, boxes, shapes, size, out_size, ratio,
                                                route=route)
    ref = KB.multiscale_roi_align_backward_reference(cot, boxes, shapes, size, out_size, ratio)
    scale = min(1.0, max([cot.abs().max().item()] + [r.abs().max().item() for r in ref]))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5 * scale)
    assert torch.equal((route // 2).int(), assign_fpn_levels(boxes, len(shapes)))
    assert torch.equal((route % 2).bool(), KR.backward_routes(shapes, boxes, size, out_size)[0])


@pytest.mark.cuda
def test_ssd_postprocess_nms_matches_plain():
    _needs_gpu()
    adapter = DM.ModelAdapter("ssd300_vgg16", 91, 300, device="cuda", seed=2)
    images = _batch("ssd300_vgg16")["images"]
    with watched(KN, "greedy_nms_cuda") as calls:
        out = adapter.detect(images)
    assert len(calls) == 1
    boxes, scores, thr, k, valid = calls[0][0]
    assert boxes.shape == (2, 1200, 4) and k == 200 and thr == 0.45
    keep, ok = KN.greedy_nms_cuda(boxes, scores, thr, k, valid)
    ref_keep, ref_ok = KN.greedy_nms_reference(boxes, scores, thr, k, valid)
    assert torch.equal(keep, ref_keep) and torch.equal(ok, ref_ok)
    assert out[3].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["maskrcnn_resnet50_fpn", "keypointrcnn_resnet50_fpn",
                                  "retinanet_resnet50_fpn", "ssd300_vgg16"])
def test_tiny_train_step_on_gpu_matches_cpu(name):
    _needs_gpu()
    models, before, losses, launches = TS.adapter_step_on_both(name)
    for k, v in losses["cpu"].items():
        torch.testing.assert_close(losses["cuda"][k].cpu(), v, rtol=TS.FRCNN_LOSS_RTOL,
                                   atol=1e-6)
    two_stage = name in DM.TWO_STAGE
    assert launches == {"cpu": (0, 0, 0), "cuda": (2, 2, 1) if two_stage else (0, 0, 0)}
    gap = TS.update_gap(models, before)
    assert gap["worst_share"] <= TS.FRCNN_UPDATE_SHARE, gap
