"""ResNet-50-FPN backbone stage ablation on one GPU (port of the JAX
package's ``analysis/backbone_ablate.py``).

    python -m object_detectors_tpu_torch.analysis.backbone_ablate [--bs 16]
        [--size 640] [--f32] [--fused] [--stem-detail] [--iters 20]
        [--device cpu]

Cumulative prefixes of the Faster R-CNN backbone (ResNet-50 with frozen
batch norm, FPN 256 with the pool block; seeded weights of
``init_frcnn_``): ``stem`` (conv1 7x7/s2, bn1, ReLU, ``max_pool_3x3_s2``),
``+layer1`` to ``+layer4``, and ``+fpn(full)``, the backbone's own call.
``--stem-detail`` first times the stem's cuts ``stem:conv``,
``stem:bnrelu`` and ``stem:pool``. ``--fused`` sets the backbone's
``fused`` to "auto": the stride-1 bottlenecks run the fused kernel
(``csrc/fused_block.cu``); their folded weights are built in the warm-up
calls, outside the timed ones. bf16 unless ``--f32``. Each stage is timed
with back-to-back calls and one synchronization at the end
(``yolo_stages.time_calls``). Prints one JSON line: the card's name and
power limit, each stage's ms, its marginal over the stage before, its
images/s and the fused kernel's launches over the run.

Left out, TPU-only (``ROADMAP.md`` ground rules, "Port the function, not
the TPU layout": the phase-split stems are not ported): the space-to-depth
stem rows ``stem:s2d_only``, ``stem:s2d_slice``, ``stem:conv_pre_s2d``,
``stem:s2d4_only``, ``stem:s2d4_rowphase``, ``stem:stem4_full``, and the
pool A/B ``stem:pool_rw`` against the phase-decomposed pool (the port's
``max_pool_3x3_s2`` is the one plain pool). ``stem:direct_conv`` is the
port's ``stem:conv``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.analysis.yolo_stages import prefix_times, timer_line
from object_detectors_tpu_torch.kernels import fused_block as KF
from object_detectors_tpu_torch.models.common import conv2d, max_pool_3x3_s2
from object_detectors_tpu_torch.models.faster_rcnn import (
    FasterRCNN, FasterRCNNConfig, init_frcnn_,
)
from object_detectors_tpu_torch.models.resnet import ResNet


def resnet_prefix(resnet: ResNet, x: torch.Tensor, n_stages: int, cut: str = "pool"):
    """The stem (to ``cut``: "conv", "bnrelu" or "pool") and the first
    ``n_stages`` stages of ``resnet`` on NCHW ``x``."""
    x = conv2d(x, resnet.conv1)
    if cut == "conv":
        return x
    x = F.relu(resnet.bn1(x))
    if cut == "bnrelu":
        return x
    x = max_pool_3x3_s2(x)
    for stage in range(n_stages):
        for i in range(resnet.layers[stage]):
            x = getattr(resnet, f"layer{stage + 1}_block{i}")(x)
    return x


def build_stages(dtype=torch.bfloat16, fused: str = "off", stem_detail: bool = False,
                 layers=(3, 4, 6, 3), device="cuda"):
    """(stages {name: fn(NCHW channels_last images)}, the backbone): the
    prefixes of the module docstring over one seeded backbone."""
    model = init_frcnn_(FasterRCNN(FasterRCNNConfig(resnet_layers=tuple(layers),
                                                    backbone_fused=fused)))
    backbone = model.backbone.to(device).eval()
    resnet = backbone.resnet
    stages = {}
    if stem_detail:
        for cut in ("conv", "bnrelu", "pool"):
            stages[f"stem:{cut}"] = lambda x, cut=cut: resnet_prefix(resnet, x, 0, cut)
    stages["stem"] = lambda x: resnet_prefix(resnet, x, 0)
    for n in range(1, len(layers) + 1):
        stages[f"+layer{n}"] = lambda x, n=n: resnet_prefix(resnet, x, n)
    stages["+fpn(full)"] = backbone
    return stages, backbone


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--fused", action="store_true",
                    help="fused bottleneck kernel in the stride-1 blocks (eval, bf16)")
    ap.add_argument("--stem-detail", action="store_true",
                    help="the stem's cuts: conv / +bnrelu / +pool")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch.float32 if args.f32 else torch.bfloat16

    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(args.bs, args.size, args.size, 3).astype(np.float32))
    x = images.to(dev, dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    stages, _ = build_stages(dtype, "auto" if args.fused else "off", args.stem_detail,
                             device=dev)
    launches = KF.launches
    with torch.inference_mode():
        ms, marginal = prefix_times(stages, x, iters=args.iters, device=dev)
    return timer_line("backbone_ablate", dev, bs=args.bs, size=args.size,
                      dtype=str(dtype).replace("torch.", ""), fused=args.fused,
                      iters=args.iters, stage_ms=ms, marginal_ms=marginal,
                      img_per_s={k: args.bs / v * 1e3 for k, v in ms.items()},
                      fused_launches=KF.launches - launches)


if __name__ == "__main__":
    main()
