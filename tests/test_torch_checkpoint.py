"""The port's checkpoints (object_detectors_tpu_torch/train/checkpoint.py) and
data parallelism (parallel/mesh.py) against the JAX package's
``train/checkpoint.py`` and ``parallel/mesh.py`` on the CPU.

The ``.meta.json`` sidecars are byte-equal to those JAX's (orbax)
``CheckpointManager`` writes for the same epoch and metrics; ``save_epoch``
picks last/best as JAX's over a metric sequence in both modes; a restore of
an absent tag is None. Resume is bitwise: one epoch, a resume and one more
epoch give the parameters, buffers and optimizer state of two epochs
straight, for the tiny YOLO through ``main.py`` and for ``--small`` Faster
R-CNN through ``detection_main`` (under deterministic algorithms, without
which two straight runs differ). At world size 1 on gloo (a ``file://``
rendezvous, no network) ``train_pipeline`` runs unchanged, and the
data-parallel size is the data axis of JAX's ``make_mesh_for_batch``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.parallel import mesh as jmesh
from object_detectors_tpu.train import checkpoint as jckpt
from object_detectors_tpu_torch import detection_main as DM
from object_detectors_tpu_torch import main as M
from object_detectors_tpu_torch.parallel import mesh
from object_detectors_tpu_torch.train import checkpoint as ckpt
from object_detectors_tpu_torch.train import optim, trainer
from object_detectors_tpu_torch.models.yolo import YoloHead, init_yolo_
from torch_threads import share_cores  # noqa: F401 (autouse)

YOLO = ["dataset=synthetic", "backbone=tiny", "dataset.num_images=8", "dataset.canvas_size=96",
        "precision=f32", "metric=mAP", "device=cpu"]
FRCNN = ["--dataset", "synthetic", "--model", "fasterrcnn_resnet50_fpn", "--small",
         "--image-size", "64", "--batch-size", "4", "--max-boxes", "8", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _drop_checkpoint_files(tmp_path):
    """The checkpoints a test writes are hundreds of MB: delete them after it."""
    yield
    for path in tmp_path.rglob("*.pt"):
        path.unlink()


def _tiny_state():
    model = init_yolo_(YoloHead(4, backbone_layers=(1, 1, 1, 1, 1)))
    tx = optim.make_optimizer(optim.OptimizerConfig(), optim.SchedulerConfig())
    return trainer.create_yolo_train_state(model, tx)


@pytest.mark.parametrize("epoch,metrics", [(0, {"metric": 0.25}), (7, {"mAP": float("nan")}),
                                           (3, {"metric": np.float32(1.5), "loss": -2})])
def test_sidecar_is_jaxs(tmp_path, epoch, metrics):
    jm = jckpt.CheckpointManager(str(tmp_path / "jax"))
    jm.save_raw("last", {"w": jnp.zeros(2)}, epoch, metrics)
    pm = ckpt.CheckpointManager(str(tmp_path / "port"))
    pm.save("last", _tiny_state(), epoch, metrics)
    assert ((tmp_path / "port" / "last.meta.json").read_bytes()
            == (tmp_path / "jax" / "last.meta.json").read_bytes())
    _, ep, met = pm.restore("last", _tiny_state())
    assert ep == epoch and list(met) == list(metrics)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_save_epoch_picks_last_and_best_as_jax(tmp_path, mode):
    seq = [0.3, 0.1, 0.5, 0.5, 0.2, 0.7, float("nan"), 0.05]
    jm = jckpt.CheckpointManager(str(tmp_path / "jax"))
    pm = ckpt.CheckpointManager(str(tmp_path / "port"))
    calls = {"jax": [], "port": []}
    jm.save = lambda tag, state, epoch, metrics: calls["jax"].append((tag, epoch))
    real_save = pm.save

    def port_save(tag, state, epoch, metrics):
        calls["port"].append((tag, epoch))
        real_save(tag, state, epoch, metrics)
    pm.save = port_save
    state = _tiny_state()
    jbest = pbest = -np.inf if mode == "max" else np.inf
    for epoch, m in enumerate(seq):
        jbest = jm.save_epoch(None, epoch, {"metric": m}, m, jbest, mode)
        pbest = pm.save_epoch(state, epoch, {"metric": m}, m, pbest, mode)
        assert pbest == jbest
    assert calls["port"] == calls["jax"]
    best_epoch = max(e for t, e in calls["jax"] if t == "best")
    assert json.loads((tmp_path / "port" / "best.meta.json").read_text())["epoch"] == best_epoch
    assert pm.restore("absent", state) is None
    assert jm.restore("absent", None) is None
    assert pm.restore_raw("absent") is None


def _payloads_equal(a: dict, b: dict, path=""):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _payloads_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _payloads_equal(x, y, f"{path}/{i}")
    else:
        assert a == b, path


def _last(out_dir, sub="checkpoints"):
    return torch.load(os.path.join(out_dir, sub, "last.pt"), weights_only=True)


def test_yolo_resume_is_bitwise(tmp_path):
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    M.main(["train", *YOLO, "epochs=2", f"output_dir={straight}"])
    M.main(["train", *YOLO, "epochs=1", f"output_dir={resumed}"])
    M.main(["train", *YOLO, "epochs=2", "resume=true", f"output_dir={resumed}"])
    _payloads_equal(_last(resumed), _last(straight))
    assert _last(straight)["optimizer"]["count"] == 4
    rows = (tmp_path / "resumed" / "progress" / "progress.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1"]  # the resume started at epoch 1
    meta = json.loads((tmp_path / "resumed" / "checkpoints" / "last.meta.json").read_text())
    assert meta["epoch"] == 1


@pytest.fixture
def deterministic():
    """Deterministic algorithms: the CPU scatter-adds of the RoIAlign
    backward otherwise sum in thread order, and two straight runs differ."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_frcnn_resume_is_bitwise(tmp_path, deterministic):
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    DM.main([*FRCNN, "--epochs", "2", "--output-dir", straight])
    DM.main([*FRCNN, "--epochs", "1", "--output-dir", resumed])
    DM.main([*FRCNN, "--epochs", "2", "--resume", "last", "--output-dir", resumed])
    a, b = _last(resumed), _last(straight)
    _payloads_equal(a, b)
    assert b["step"] == 8 and b["optimizer"]["count"] == 8
    assert sorted(os.listdir(os.path.join(resumed, "checkpoints"))) == [
        "last.meta.json", "last.pt", "model_0.meta.json", "model_0.pt", "model_1.meta.json",
        "model_1.pt"]


def test_train_pipeline_at_world_size_one_on_gloo(tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not torch.distributed.is_initialized()
    mesh.maybe_initialize_distributed()  # one process, no URL: nothing to join
    assert not torch.distributed.is_initialized()
    mesh.maybe_initialize_distributed(init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert (mesh.process_index(), mesh.process_count()) == (0, 1)
        model = torch.nn.Linear(2, 2)
        assert mesh.data_parallel(model) is model
        x = torch.tensor([1.0, 3.0])
        assert mesh.all_reduce_mean(x) is x
        assert mesh.per_process_batch(6) == 6
        cfg = M.load_config(M.CONFIG_DIR, [*YOLO, "epochs=1", f"output_dir={tmp_path / 'run'}"])
        state, best = M.train_pipeline(cfg)
        assert np.isfinite(best) and state.step == 2
        assert (tmp_path / "run" / "checkpoints" / "best.pt").exists()
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("devices", [1, 2, 3, 4, 8])
def test_data_parallel_size_is_make_mesh_for_batch(devices):
    for batch in range(1, 17):
        want = jmesh.make_mesh_for_batch(batch, devices=jax.devices()[:devices]).shape["data"]
        assert mesh.data_parallel_size(batch, devices) == want, (batch, devices)
