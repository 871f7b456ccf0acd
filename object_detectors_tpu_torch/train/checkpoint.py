"""Checkpoints: best/last semantics of the reference (port of the JAX
package's ``train/checkpoint.py``, which writes orbax directories).

Parity with `yolo/procedures/initialize.py:12-25,57-104` and
`detection/train.py:189-196`: every epoch rank 0 writes ``last`` (model,
optimizer, step, epoch and metrics) and also ``best`` when the selection
metric improves; resume restores everything and offsets the epoch counter.

A checkpoint is one ``torch.save`` file, ``<dir>/<tag>.pt``: the model's
``state_dict`` (of the module inside a DDP wrapper, so without the
``module.`` prefix), the ``ScheduledOptimizer``'s state (the inner
optimizer's ``state_dict``, ``count`` and ``plateau_scale``) and the step.
The epoch and the metrics go to the same ``<dir>/<tag>.meta.json`` sidecar
as in JAX: ``{"epoch": int, "metrics": {name: float}}``. Everything saved
is tensors and plain Python values, so ``restore`` loads with
``weights_only=True``.
"""

from __future__ import annotations

import json
import os

import torch

from object_detectors_tpu_torch.parallel import mesh


def unwrapped(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a ``DistributedDataParallel`` wrapper, or ``model``."""
    return getattr(model, "module", model)


def state_payload(state) -> dict:
    """A ``TrainState`` as the tensors and values a checkpoint holds."""
    opt = state.optimizer
    return {"model": unwrapped(state.model).state_dict(),
            "optimizer": {"inner": opt.optimizer.state_dict(), "count": opt.count,
                          "plateau_scale": opt.plateau_scale},
            "step": state.step}


def load_state_payload(state, payload: dict):
    """Put a checkpoint's payload into ``state`` in place; returns it."""
    unwrapped(state.model).load_state_dict(payload["model"])
    opt = payload["optimizer"]
    state.optimizer.optimizer.load_state_dict(opt["inner"])
    state.optimizer.count = int(opt["count"])
    state.optimizer.plateau_scale = float(opt["plateau_scale"])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, tag)

    def _write_meta(self, path: str, epoch: int, metrics: dict):
        with open(path + ".meta.json", "w") as f:
            json.dump({"epoch": int(epoch),
                       "metrics": {k: float(v) for k, v in metrics.items()}}, f)

    def _read_meta(self, path: str):
        epoch, metrics = 0, {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
            epoch, metrics = meta.get("epoch", 0), meta.get("metrics", {})
        return epoch, metrics

    def save(self, tag: str, state, epoch: int, metrics: dict):
        """Save a ``TrainState`` under ``<dir>/<tag>.pt`` with its sidecar."""
        self.save_raw(tag, state_payload(state), epoch, metrics)

    def restore(self, tag: str, state):
        """Restore into ``state`` (in place); returns (state, epoch,
        metrics), or None if the tag is absent."""
        out = self.restore_raw(tag)
        if out is None:
            return None
        payload, epoch, metrics = out
        return load_state_payload(state, payload), epoch, metrics

    def save_raw(self, tag: str, payload: dict, epoch: int, metrics: dict):
        """Save a dict of tensors and plain values, and the sidecar."""
        path = self._path(tag)
        torch.save(payload, path + ".pt")
        self._write_meta(path, epoch, metrics)

    def restore_raw(self, tag: str):
        """(payload, epoch, metrics), or None if the tag is absent. The
        tensors load on the CPU."""
        path = self._path(tag)
        if not os.path.exists(path + ".pt"):
            return None
        payload = torch.load(path + ".pt", map_location="cpu", weights_only=True)
        return (payload, *self._read_meta(path))

    def save_epoch(self, state, epoch: int, metrics: dict, metric_value: float,
                   best_so_far: float, mode: str = "max") -> float:
        """last + conditional best (main.py:110-126); only rank 0 writes.
        Returns the new best value."""
        if mesh.process_index() == 0:
            self.save("last", state, epoch, metrics)
        improved = (metric_value > best_so_far if mode == "max"
                    else metric_value < best_so_far)
        if improved:
            if mesh.process_index() == 0:
                self.save("best", state, epoch, metrics)
            return metric_value
        return best_so_far
