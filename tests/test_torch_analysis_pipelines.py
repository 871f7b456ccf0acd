"""The port's Faster R-CNN, RetinaNet, training and serving timers
(``object_detectors_tpu_torch/analysis/{frcnn,retinanet,train,serving}_
ablate.py``) on the CPU with tiny models: each ``full`` stage is the
pipeline's own call, the leave-one-out and piecewise stages give what the
pipeline gives (bitwise), the cut stages stop where they should, the
training stages leave the model they copy untouched, and the serving
split counts the stream's flushes.

The JAX package's timers are not run here: their stages reduce to
scalars, and the ones compared above are the port's own pipelines, held
to JAX by ``test_torch_frcnn.py``, ``test_torch_retinanet.py``,
``test_torch_train.py`` and ``test_torch_serve.py``."""

import numpy as np
import pytest
import torch

from object_detectors_tpu_torch import serve as S
from object_detectors_tpu_torch.analysis import (
    frcnn_ablate, retinanet_ablate, serving_ablate, train_ablate,
)
from object_detectors_tpu_torch.analysis.yolo_stages import run_through
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.models.faster_rcnn import (
    FasterRCNN, FasterRCNNConfig, init_frcnn_,
)
from object_detectors_tpu_torch.models.retinanet import RetinaNet, init_retinanet_
from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
from object_detectors_tpu_torch.pipeline import build_frcnn_pipeline_uint8
from torch_threads import share_cores  # noqa: F401  (trains a model)

IMG = 64


def images(bs=2, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(bs, IMG, IMG, 3).astype(
        np.float32))


@pytest.fixture(scope="module")
def frcnn_stages():
    model = init_frcnn_(FasterRCNN(FasterRCNNConfig(num_classes=5, resnet_layers=(1, 1, 1, 1))))
    return frcnn_ablate.build_stages(torch.float32, IMG, "cpu", model=model), model


def test_frcnn_full_is_the_pipeline_s_call(frcnn_stages):
    (stages, model), tiny = frcnn_stages
    x = images()
    with torch.inference_mode():
        full = stages["full"](x)
        pipe = build_frcnn_pipeline_uint8(img_size=IMG, dtype=torch.float32, device="cpu",
                                          model=tiny).model
        assert frcnn_ablate.same_detections(full, pipe(x))
        assert frcnn_ablate.same_detections(full, stages["full_pieces"](x))
        for name in ("full_no_pooler", "full_no_filter"):
            out = stages[name](x)
            assert [tuple(t.shape) for t in out] == [tuple(t.shape) for t in full], name
    assert list(stages) == ["backbone", "rpn_head", "filter_topk", "filter_nms",
                            "proposal_filter", "roi_align", "box_heads", "full",
                            "full_pieces", "full_no_pooler", "full_no_filter"]


def test_frcnn_cut_stages_stop_at_their_marks(frcnn_stages):
    (stages, model), _ = frcnn_stages
    x = images()
    seen = []
    with torch.inference_mode():
        model(x, on_stage=seen.append)
        for name in ("backbone", "rpn_head", "proposal_filter", "roi_align", "box_heads"):
            assert stages[name](x) is None
        boxes, scores = stages["filter_topk"](x)
        assert boxes.shape == (2, 5, 1000, 4) and scores.shape == (2, 5, 1000)
        assert stages["filter_nms"](x).shape == (2, 5000)
        with pytest.raises(ValueError, match="never reached"):
            run_through(model, "no such stage", x)
    assert seen == ["backbone+FPN", "RPN head", "proposal filter", "pooler", "box head",
                    "postprocess"]


def test_frcnn_dummy_stand_ins_have_the_real_shapes():
    feats = [torch.randn(2, 8, 16, 16), torch.randn(2, 8, 8, 8)]
    boxes = torch.rand(2, 30, 4) * 30
    pooled = frcnn_ablate.dummy_pool(feats, boxes)
    assert pooled.shape == (2, 30, 7, 7, 8)
    assert torch.equal(pooled[1, 29], feats[0][1, :, :7, :7].permute(1, 2, 0))
    props = torch.rand(2, 100, 4) * 40
    props[..., 2:] += props[..., :2]
    b, s, v = frcnn_ablate.dummy_filter(props, torch.randn(2, 100), (64, 64), 30)
    assert b.shape == (2, 30, 4) and s.shape == v.shape == (2, 30) and bool(v.all())
    assert float(b.max()) <= 64


def test_retinanet_pieces_equal_the_pipeline():
    model = init_retinanet_(RetinaNet(5, (1, 1, 1, 1)))
    stages, pipe = retinanet_ablate.build_stages(IMG, device="cpu", model=model)
    ref = S.build_retinanet_pipeline(img_size=IMG, device="cpu", model=model)
    x = images(seed=1).to(torch.bfloat16)
    with torch.inference_mode():
        full = stages["full"](x)
        assert frcnn_ablate.same_detections(full, ref(x))
        assert frcnn_ablate.same_detections(full, stages["full_pieces"](x))
        boxes, scores, labels, valid = stages["post_decode"](x)
        assert boxes.shape[:2] == scores.shape == valid.shape
        assert stages["backbone"](x) is None
        assert len(stages["backbone_nofpn"](x)) == 4
        assert len(stages["post_select"](x)) == len(stages["post_cap"](x)) == 4
    assert list(stages) == ["backbone", "backbone_nofpn", "head", "post_select", "post_cap",
                            "post_decode", "full", "full_pieces"]


def test_train_stages_leave_the_model_untouched():
    model = init_yolo_(YoloHead(80, backbone_layers=(1, 1, 1, 1, 1)), seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    batch = train_ablate.make_batch(2, IMG, rng, "cpu")
    batch["images"] = batch["images"].float()
    canvas, sizes = train_ablate.make_canvas(2, rng, "cpu")
    cfg = YC.YoloLossConfig(num_classes=80, img_size=IMG)
    stages = train_ablate.build_stages(model, batch, canvas, sizes, cfg)
    assert list(stages) == ["fwd_eval", "fwd_train", "fwd_loss", "grad", "full", "full_ingest"]
    outs = {name: fn() for name, fn in stages.items()}
    assert outs["fwd_loss"] == outs["grad"]  # the same weights and batch, train mode
    assert all(np.isfinite(float(outs[k])) for k in ("fwd_loss", "full", "full_ingest"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert batch["gt_boxes"].shape == (2, 32, 4) and canvas.shape == (2, 640, 640, 3)
    assert bool((sizes >= 320).all() and (sizes <= 640).all())


def test_serving_split_counts_the_stream_s_flushes():
    pipes = {
        "yolo": S.build_yolo_pipeline(num_classes=4, img_size=IMG, uint8_input=True,
                                      device="cpu", model=init_yolo_(YoloHead(
                                          4, backbone_layers=(1, 1, 1, 1, 1)))),
        "retinanet": S.build_retinanet_pipeline(num_classes=5, img_size=IMG, uint8_input=True,
                                                device="cpu", model=init_retinanet_(
                                                    RetinaNet(5, (1, 1, 1, 1)))),
    }
    server = S.BatchedDetectionServer(pipes, {"yolo": 4, "retinanet": 2},
                                      input_dtype=torch.uint8, device="cpu", max_delay_s=100)
    server.stage_pool(np.random.RandomState(4).randint(0, 255, (32, IMG, IMG, 3),
                                                       dtype=np.uint8))
    line = serving_ablate.run(server, 20, serving_ablate.measure_rpc_cost("cpu", iters=3))
    # 16 YOLO requests in flushes of 4, 4 RetinaNet in flushes of 2
    assert line["flushes"] == {"yolo": 4, "retinanet": 2} and line["rpcs"] == 18
    # the warm-up (the first 4 + 2 requests: 4 YOLO, 2 RetinaNet), the kernel
    # budget and the stream
    assert server.flushes == {"yolo": 1 + 4 + 4, "retinanet": 1 + 2 + 2}
    assert not server.pending
    assert line["predicted_floor_s"] == max(line["predicted_rpc_floor_s"],
                                            line["kernel_sum_s"])
    assert line["wall_s"] > 0 and line["kernel_sum_s"] > 0
