"""Serving dispatch budget on one GPU (port of the JAX package's
``analysis/serving_ablate.py``).

    python -m object_detectors_tpu_torch.analysis.serving_ablate
        [--n-requests 256] [--img-size 640] [--yolo-bs 32] [--retina-bs 8]
        [--device cpu]

Splits the mixed serving stream (``serve.BatchedDetectionServer``: YOLO
top-512 and RetinaNet at 4:1, uint8 requests as slots of a seeded 32-image
pool on the device, flushes of ``--yolo-bs`` and ``--retina-bs``, up to
four in flight; a warm-up stream of one flush of each first) into three
parts:

* the per-interaction floor: one tiny host-to-device copy, one launch and
  one device-to-host copy with its synchronization, the median of 30
  loops over three ("rpc_cost_ms": JAX's relay RPC, read here as one host
  interaction with the card);
* the kernel budget: the stream's flushes, each through the server's own
  flush function (``_flush``) on the staged pool, back to back within the
  server's limit of four in flight, and one synchronization at the end
  ("kernel_sum_s");
* the measured stream: ``run_stream`` over all the requests ("wall_s").

A flush costs three interactions (the slots' copy, the launch of its
graph, the packed result's copy back), so the stream's interaction floor
is 3 x flushes x the per-interaction cost. The normalize
(``csrc/preprocess.cu``) and NMS (``csrc/nms.cu``) kernels run in every
flush; their launches over the kernel budget are counted. Prints one JSON
line with the JAX timer's keys, the card's name and power limit, and the
launches.

The JAX timer has no TPU-only variant.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from object_detectors_tpu_torch import serve as S
from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.yolo_stages import synchronize, timer_line
from object_detectors_tpu_torch.kernels import nms as KN
from object_detectors_tpu_torch.kernels import preprocess as KP

INTERACTIONS_PER_FLUSH = 3


def measure_rpc_cost(device, iters: int = 30) -> float:
    """Median seconds of one host interaction: a loop of a tiny copy to the
    device, one launch and a copy back (which synchronizes), over three."""
    x = torch.zeros(8)
    ts = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        (x.to(device) + 1.0).cpu()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts[1:])) / INTERACTIONS_PER_FLUSH


def dispatch_budget(server, reqs, flushes: dict) -> float:
    """Seconds of ``flushes`` ({model: count}) run through the server's
    flush function back to back, each on a full batch of the first of
    ``reqs``' slots for its model: the server's own in-flight limit (a
    flush past it waits for the oldest's result, while the ones behind it
    keep the device busy), then the rest drained and one synchronization
    at the end."""
    synchronize(server.device)
    t0 = time.perf_counter()
    for model, count in flushes.items():
        first = [r for r in reqs if r.model == model][: server.batch_size[model]]
        for _ in range(count):
            for r in first:
                server.submit(r)
            server._flush(model)
    server.drain()
    synchronize(server.device)
    return time.perf_counter() - t0


def run(server, n_requests: int, rpc_s: float) -> dict:
    """The three parts of the module docstring on ``server`` (its pool
    staged): the JAX timer's keys, and the kernels' launches over the
    kernel budget."""
    reqs = [S.Request(i, "yolo" if i % 5 else "retinanet", i % 32) for i in range(n_requests)]
    bs = server.batch_size
    server.run_stream(reqs[: bs["yolo"] + bs["retinanet"]])  # warm-up
    n_yolo = sum(1 for r in reqs if r.model == "yolo")
    flushes = {"yolo": -(-n_yolo // bs["yolo"]),
               "retinanet": -(-(n_requests - n_yolo) // bs["retinanet"])}
    rpcs = INTERACTIONS_PER_FLUSH * sum(flushes.values())
    before = {"preprocess": KP.launches, "nms": KN.launches}
    kernel_s = dispatch_budget(server, reqs, flushes)
    launches = {"preprocess": KP.launches - before["preprocess"],
                "nms": KN.launches - before["nms"]}
    t0 = time.perf_counter()
    out = server.run_stream(reqs)
    wall_s = time.perf_counter() - t0
    if len(out) != n_requests:
        raise RuntimeError(f"the stream answered {len(out)} of {n_requests} requests")
    pred_rpc_s = rpcs * rpc_s
    return {"metric": "serving_dispatch_budget", "img_per_s": n_requests / wall_s,
            "wall_s": wall_s, "flushes": flushes, "rpcs": rpcs, "rpc_cost_ms": rpc_s * 1e3,
            "predicted_rpc_floor_s": pred_rpc_s, "kernel_sum_s": kernel_s,
            "predicted_floor_s": max(pred_rpc_s, kernel_s),
            "relay_bound": bool(pred_rpc_s > kernel_s),
            "scheduler_overhead_s": wall_s - max(pred_rpc_s, kernel_s),
            "kernel_budget_launches": launches}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-requests", type=int, default=256)
    ap.add_argument("--img-size", type=int, default=640)
    ap.add_argument("--yolo-bs", type=int, default=32)
    ap.add_argument("--retina-bs", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rpc_s = measure_rpc_cost(dev)
    pipelines = {
        "yolo": S.build_yolo_pipeline(img_size=args.img_size, batch_size=args.yolo_bs,
                                      uint8_input=True, device=dev),
        "retinanet": S.build_retinanet_pipeline(img_size=args.img_size, uint8_input=True,
                                                device=dev),
    }
    server = S.BatchedDetectionServer(pipelines, {"yolo": args.yolo_bs,
                                                  "retinanet": args.retina_bs},
                                      input_dtype=torch.uint8, device=dev)
    server.stage_pool(np.random.RandomState(4).randint(
        0, 255, (32, args.img_size, args.img_size, 3), dtype=np.uint8))
    return timer_line("serving_ablate", dev, n_requests=args.n_requests,
                      img_size=args.img_size, yolo_bs=args.yolo_bs,
                      retina_bs=args.retina_bs, **run(server, args.n_requests, rpc_s))


if __name__ == "__main__":
    main()
