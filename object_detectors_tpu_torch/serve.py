"""Mixed-model batched serving (port of the JAX package's ``serve.py``).

* each model has one fixed-batch inference pipeline;
* requests carry a model name and wait in per-model queues; a queue is
  flushed when it reaches its batch size or its deadline passes, a short
  batch padded with its last image (the padding rows are dropped on the way
  out);
* responses keep their request ids, so interleaved streams demultiplex.

A request's image is a slot of the image pool staged on the device with
``stage_pool`` (an int), a tensor (already on the device, the counterpart of
the JAX version's device array) or a host numpy array. A flush queues the
batch gather (``index_select`` of the pool, with the slots copied to the
device without blocking), the cast, the pipeline and the pack of its four
outputs into one ``[B, K, 7]`` float32 tensor (boxes, score, label, valid),
then a non-blocking copy of that tensor into its own pinned host buffer and
a CUDA event: nothing in a flush waits for the device. Up to
``max_inflight`` flushes stay queued; ``_resolve`` waits on one flush's event
and nothing else. A pinned buffer belongs to its flush until the flush is
resolved, so none is reused while its copy is in flight; the responses then
hold a copy and the buffer goes back to PyTorch's pinned-memory cache. On the CPU a flush runs to its end and has no
event. Labels pass the float32 pack exactly (every class id, 1203 at most,
and RetinaNet's -1 are below 2^24 in magnitude).

``build_yolo_pipeline`` and ``build_retinanet_pipeline`` are the two serving
pipelines, with the reference's names and defaults. Not ported: the JAX
version's ``fused_towers`` and ``select_mode`` (a TPU device and measured
losers).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.models.retinanet import RetinaNet, init_retinanet_
from object_detectors_tpu_torch.pipeline import (
    RetinanetPipeline, YoloPipeline, build_pipeline, place_model,
)


@dataclasses.dataclass
class Request:
    request_id: int
    model: str
    # [H, W, 3] image: an int slot of the server's pool (see stage_pool), a
    # torch tensor, or a numpy array
    image: object


@dataclasses.dataclass
class Response:
    request_id: int
    model: str
    boxes: np.ndarray
    scores: np.ndarray
    labels: np.ndarray
    valid: np.ndarray
    latency_s: float


@dataclasses.dataclass
class _InFlight:
    """A dispatched flush: its requests, the packed result's host buffer and
    the event recorded after the copy into it (None on the CPU)."""

    model: str
    items: list
    host: torch.Tensor
    done: torch.cuda.Event | None


class BatchedDetectionServer:
    def __init__(self, pipelines: dict[str, Callable], batch_size, max_delay_s: float = 0.01,
                 input_dtype: torch.dtype | None = None, device: str | torch.device = "cuda"):
        """pipelines: {name: callable [B, H, W, 3] -> (boxes, scores, labels,
        valid)} on ``device``. batch_size: int, or {model: int}. input_dtype:
        cast batches to it before dispatch."""
        self.pipelines = pipelines
        self.input_dtype = input_dtype
        self.device = resolve_device(device)
        if isinstance(batch_size, int):
            batch_size = {m: batch_size for m in pipelines}
        self.batch_size = batch_size
        self.max_delay_s = max_delay_s
        self.queues: dict[str, deque] = {m: deque() for m in pipelines}
        self.deadlines: dict[str, float] = {}
        # dispatched flushes, oldest first; responses are read in drain()/poll()
        self.pending: deque = deque()
        self.max_inflight = 4
        self.pool = None                  # device tensor [P, H, W, 3]
        self.flushes = {m: 0 for m in pipelines}

    def stage_pool(self, images):
        """Put an image pool [P, H, W, 3] on the device; requests then carry
        slot indices, and a flush gathers its batch from the pool."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.asarray(images))
        self.pool = images.to(self.device)
        return self.pool

    def submit(self, req: Request):
        q = self.queues[req.model]
        if not q:
            self.deadlines[req.model] = time.perf_counter() + self.max_delay_s
        q.append((req, time.perf_counter()))

    def _batch(self, images: list, bs: int) -> torch.Tensor:
        """The requests' images padded with the last to ``bs``, on the device."""
        images = images + images[-1:] * (bs - len(images))
        if isinstance(images[0], (int, np.integer)):
            idx = torch.tensor([int(i) for i in images], dtype=torch.int64)
            if self.device.type == "cuda":
                idx = idx.pin_memory()
            return self.pool.index_select(0, idx.to(self.device, non_blocking=True))
        if isinstance(images[0], torch.Tensor):
            return torch.stack(images).to(self.device)
        return torch.from_numpy(np.stack(images)).to(self.device)

    def _flush(self, model: str) -> list[Response]:
        q = self.queues[model]
        n = min(len(q), self.batch_size[model])
        items = [q.popleft() for _ in range(n)]
        batch = self._batch([req.image for req, _ in items], self.batch_size[model])
        if self.input_dtype is not None:
            batch = batch.to(self.input_dtype)
        boxes, scores, labels, valid = self.pipelines[model](batch)
        packed = torch.cat([boxes.float(), scores.float()[..., None],
                            labels.float()[..., None], valid.float()[..., None]], -1)
        done = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = packed
        self.flushes[model] += 1
        self.pending.append(_InFlight(model, items, host, done))
        out = []
        if len(self.pending) > self.max_inflight:
            out.extend(self._resolve(self.pending.popleft()))
        return out

    def _resolve(self, entry: _InFlight) -> list[Response]:
        if entry.done is not None:
            entry.done.synchronize()
        p = entry.host.numpy().copy()  # frees the pinned buffer for a later flush
        boxes, scores = p[..., :4], p[..., 4]
        labels, valid = p[..., 5].astype(np.int32), p[..., 6] > 0.5
        now = time.perf_counter()
        return [Response(req.request_id, entry.model, boxes[i], scores[i], labels[i], valid[i],
                         now - t_in)
                for i, (req, t_in) in enumerate(entry.items)]

    def drain(self) -> list[Response]:
        out = []
        while self.pending:
            out.extend(self._resolve(self.pending.popleft()))
        return out

    def poll(self, force: bool = False) -> list[Response]:
        """Flush any queue that is full or past its deadline."""
        out = []
        now = time.perf_counter()
        for model, q in self.queues.items():
            while len(q) >= self.batch_size[model]:
                out.extend(self._flush(model))
            if q and (force or now >= self.deadlines.get(model, now)):
                out.extend(self._flush(model))
        if force:
            out.extend(self.drain())
        return out

    def run_stream(self, requests) -> list[Response]:
        """Synchronous loop: feed all requests, flush everything."""
        out = []
        for req in requests:
            self.submit(req)
            out.extend(self.poll())
        out.extend(self.poll(force=True))
        return out


def build_yolo_pipeline(num_classes: int = 80, img_size: int = 640, batch_size: int = 64,
                        dtype: torch.dtype = torch.bfloat16, topk: int = 512,
                        max_det: int = 100, uint8_input: bool = False,
                        **kwargs) -> YoloPipeline:
    """The YOLO serving pipeline: the bench graph (``pipeline.build_pipeline``)
    at top-512; ``uint8_input=True`` puts the normalize kernel in front, so
    requests ship raw uint8. ``batch_size`` is the reference's argument and
    changes nothing (the graph takes any batch); ``kwargs`` go to
    ``build_pipeline`` (``model``, ``backbone_layers``, ``device``)."""
    del batch_size
    return build_pipeline(num_classes, img_size, topk, max_det, dtype, uint8=uint8_input,
                          **kwargs)


def build_retinanet_pipeline(num_classes: int = 91, img_size: int = 640,
                             resnet_layers: Sequence[int] = (3, 4, 6, 3),
                             dtype: torch.dtype = torch.bfloat16, uint8_input: bool = False,
                             device: str | torch.device = "cuda",
                             model: RetinaNet | None = None) -> RetinanetPipeline:
    """The RetinaNet serving pipeline (the ``retinanet640`` graph): the
    normalize kernel in front when ``uint8_input``, else an already
    normalized float batch. Without ``model``, a ``RetinaNet`` of
    ``resnet_layers`` gets the seeded random init (seed 0), backbone
    unfused; a given model is copied, so the caller's stays on its device
    and dtype, and the copy runs its parameters as they are with activations
    in ``dtype``."""
    dev = resolve_device(device)
    model = place_model(model, lambda: init_retinanet_(RetinaNet(num_classes,
                                                                 tuple(resnet_layers))),
                        dtype, dev)
    return RetinanetPipeline(model, dtype, img_size, dev, uint8=uint8_input)
