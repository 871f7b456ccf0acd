"""The port's uint8 serving pipeline (object_detectors_tpu_torch/pipeline.py)
end to end against the JAX bench graph, its device rules, and the rule that
the port imports nothing of JAX or of the JAX package."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.kernels.preprocess import preprocess_images as jax_preprocess
from object_detectors_tpu_torch import pipeline as PL
from object_detectors_tpu_torch import serve as S
from test_torch_yolo import LAYERS, NUM_CLASSES, randomized_flax_variables, torch_model

# bench.py points JAX's persistent compile cache into the repository when
# imported; put the setting back so that the tests write nothing there.
_saved = {k: getattr(jax.config, k) for k in (
    "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
import bench  # noqa: E402

for _k, _v in _saved.items():
    jax.config.update(_k, _v)

ROOT = Path(__file__).resolve().parent.parent


def test_uint8_pipeline_matches_bench_graph():
    img, topk, conf = 128, 8, 0.001  # 16 blocks of 64 > topk: the blocked path
    flax_model, variables = randomized_flax_variables(img, seed=1)
    u8 = np.random.RandomState(7).randint(0, 256, (2, img, img, 3)).astype(np.uint8)

    core = bench.build_pipeline(num_classes=NUM_CLASSES, img_size=img, topk=topk,
                                dtype=jnp.float32, conf=conf, variables=variables,
                                backbone_layers=LAYERS)
    ref = [np.asarray(r) for r in core(jax_preprocess(jnp.asarray(u8), jnp.float32))]

    pipe = PL.build_pipeline_uint8(num_classes=NUM_CLASSES, img_size=img, topk=topk,
                                   dtype=torch.float32, conf=conf,
                                   model=torch_model(variables), device="cpu")
    out = [t.numpy() for t in pipe(torch.from_numpy(u8))]

    assert out[0].shape == (2, 100, 4)
    np.testing.assert_array_equal(out[3], ref[3])  # valid
    np.testing.assert_array_equal(out[2], ref[2])  # labels
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-5, atol=1e-4)  # pixels
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-5, atol=1e-6)
    assert 0 < ref[3].sum(axis=1).min() and ref[3].sum(axis=1).max() < topk  # NMS dropped some


def test_yolo_serving_pipeline_defaults_and_output():
    pipe = S.build_yolo_pipeline(num_classes=NUM_CLASSES, img_size=64, uint8_input=True,
                                  backbone_layers=LAYERS, device="cpu")
    assert (pipe.topk, pipe.max_det, pipe.conf, pipe.iou_thr, pipe.dtype) == (
        512, 100, 0.1, 0.6, torch.bfloat16)
    u8 = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8))
    boxes, scores, labels, valid = pipe(u8)
    assert boxes.shape == (2, 100, 4) and scores.shape == labels.shape == valid.shape == (2, 100)
    assert torch.isfinite(boxes).all() and labels.dtype == torch.int32


def test_bench_defaults_are_kept():
    pipe = PL.build_pipeline_uint8(backbone_layers=LAYERS, device="cpu", img_size=64)
    assert (pipe.num_classes, pipe.topk, pipe.max_det, pipe.conf, pipe.iou_thr,
            pipe.dtype, pipe.uint8) == (80, 256, 100, 0.1, 0.6, torch.bfloat16, True)
    assert PL.build_pipeline.__defaults__[:7] == (80, 640, 256, 100, torch.bfloat16, 0.1, 0.6)


def test_given_model_is_left_as_it_was():
    model = PL.init_yolo_(PL.YoloHead(NUM_CLASSES, PL.ANCHORS_PER_SCALE, LAYERS))
    model.dtype = torch.float32
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pipe = PL.build_pipeline(num_classes=NUM_CLASSES, img_size=64, dtype=torch.bfloat16,
                             model=model, device="cpu")
    assert pipe.model is not model and pipe.model.dtype == torch.bfloat16
    assert model.dtype == torch.float32
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_cuda_pipeline_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PL.build_pipeline_uint8(backbone_layers=LAYERS)


FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|orbax|msgpack|pandas|object_detectors_tpu)\b",
    re.MULTILINE)
# the image and YAML libraries, which the card may lack, only inside functions
AT_MODULE_LEVEL = re.compile(r"^(import|from)\s+(cv2|PIL|yaml)\b", re.MULTILINE)
# a C/C++/CUDA source of the port includes nothing of the JAX package's tree
FOREIGN_INCLUDE = re.compile(r'^\s*#\s*include\s*["<][^">]*(native|object_detectors_tpu)/',
                             re.MULTILINE)
PORT_SOURCES = sorted(str(p.relative_to(ROOT)) for p in [
    *(ROOT / "object_detectors_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
    *(ROOT / "object_detectors_tpu_torch" / "csrc").glob("*.c*")])


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_imports_nothing_of_jax(path):
    source = (ROOT / path).read_text()
    if path.endswith(".py"):
        assert not FORBIDDEN.search(source), f"{path} imports JAX, pandas or the JAX package"
        assert not AT_MODULE_LEVEL.search(source), f"{path} imports cv2, PIL or yaml at import"
    else:
        assert not FOREIGN_INCLUDE.search(source), f"{path} includes a file of the JAX package"


def test_import_guard_covers_the_data_and_eval_layer():
    for name in ("data/coco.py", "data/transforms.py", "data/masks.py", "eval/coco_map.py",
                 "eval/native.py", "utils/config.py", "csrc/coco_eval_core.cpp",
                 "csrc/nms.cu"):
        assert f"object_detectors_tpu_torch/{name}" in PORT_SOURCES, name


def test_chip_smoke_runs_yolo640_at_the_bench_batch():
    """The yolo640 row of bench.py's default run is batch 128; chip_smoke's
    yolo640 e2e phase runs at that batch."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert re.search(r"^\s+sizes = \(128,\)$", (ROOT / "bench.py").read_text(), re.MULTILINE)
    assert smoke.BATCH == 128 and (smoke.IMG, smoke.NUM_CLASSES) == (640, 80)
