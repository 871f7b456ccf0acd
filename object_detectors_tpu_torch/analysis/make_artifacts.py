"""Deterministic trained-weight artifacts for the accuracy harnesses (port of
the JAX package's ``analysis/make_artifacts.py``).

There are no pretrained checkpoints and no network, so the hermetic
fallback is to train on the renderable synthetic set (tiny YOLO, 64
images, 60 epochs; the R-CNNs at 96 px) through the port's own CLIs
(``main.py`` and ``detection_main.main``) and keep the weights. The card
has no msgpack and its copy of the repository leaves out ``artifacts/``, so
the port writes its own: ``torch.save`` files with the JAX package's
``.json`` metadata, under the git-ignored ``output/artifacts_torch/``
(never ``artifacts/``, the JAX package's).

Usage:
  python -m object_detectors_tpu_torch.analysis.make_artifacts [--yolo]
      [--frcnn] [--maskrcnn] [--kprcnn] [--epochs N] [--device cpu]
      [config overrides for the YOLO, e.g. dataset.num_images=8]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARTIFACTS = os.path.join(ROOT, "output", "artifacts_torch")

YOLO_OVERRIDES = [
    "dataset=synthetic", "backbone=tiny", "dataset.num_images=64",
    "dataset.tr_batch_size=8", "dataset.ts_batch_size=8",
    "epochs=60", "metric=mAP", "optimizer=adam", "optimizer.lr=1e-3",
    "scheduler=multistep", "scheduler.milestones=[40,52]",
    "experiment.name=artifact_yolo", "seed=0",
]


def _save(path: str, state_dict: dict, meta: dict):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"saved {path}")


def train_yolo(epochs: int | None = None, device: str = "cuda", overrides=()):
    """The tiny YOLO on the renderable synthetic set; saves its best
    checkpoint's weights and returns the best mAP."""
    from object_detectors_tpu_torch import main as pipeline
    from object_detectors_tpu_torch.train import checkpoint as ckpt_lib
    from object_detectors_tpu_torch.utils.config import CONFIG_DIR, load_config

    ov = list(YOLO_OVERRIDES)
    if epochs:
        ov = [o for o in ov if not o.startswith("epochs=")] + [f"epochs={epochs}"]
    ov += [f"device={device}", f"output_dir={os.path.join(ARTIFACTS, 'runs', 'yolo')}"]
    ov += list(overrides)
    cfg = load_config(CONFIG_DIR, ov)
    state, best = pipeline.train_pipeline(cfg)

    # the best checkpoint (train_pipeline returns the last state)
    ckpt = ckpt_lib.CheckpointManager(os.path.join(str(cfg.output_dir), str(cfg.experiment.cp)))
    restored = ckpt.restore("best", state)
    if restored:
        state = restored[0]
    meta = {"model": "yolo_tiny", "num_classes": int(cfg.yolo.classes),
            "img_size": int(cfg.yolo.img_size),
            "backbone_layers": list(cfg.backbone.layers), "best_map": float(best),
            "overrides": ov}
    _save(os.path.join(ARTIFACTS, "synthetic_yolo.pt"),
          ckpt_lib.unwrapped(state.model).state_dict(), meta)
    print(f"best mAP {best:.4f}")
    return best


def load_yolo_artifact(device: str | torch.device = "cuda"):
    """-> (``YoloHead`` with the trained weights on ``device``, meta), or
    (None, None) where the artifact is absent or does not load: the JAX
    loader's "no artifact" answer, on which the protocol scores seeded
    weights. A CUDA ``device`` without a GPU raises."""
    from object_detectors_tpu_torch._device import resolve_device
    from object_detectors_tpu_torch.models.yolo import YoloHead

    device = resolve_device(device)
    path = os.path.join(ARTIFACTS, "synthetic_yolo.pt")
    if not (os.path.exists(path) and os.path.exists(path + ".json")):
        return None, None
    try:
        with open(path + ".json") as f:
            meta = json.load(f)
        model = YoloHead(num_classes=meta["num_classes"],
                         backbone_layers=tuple(meta["backbone_layers"]))
        model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    except (KeyError, RuntimeError, ValueError, OSError, pickle.UnpicklingError) as e:
        # a stale or partial artifact (sidecar and weights disagree)
        print(f"load_yolo_artifact: stale artifact ignored ({e})")
        return None, None
    return model.to(device), meta


def _train_detection(model: str, tag: str, num_classes: int, epochs: int, device: str):
    """One of the R-CNNs at full R50-FPN width on the renderable synthetic
    set through ``detection_main.main``; saves its final weights."""
    from object_detectors_tpu_torch import detection_main as DM
    from object_detectors_tpu_torch.train.checkpoint import unwrapped

    state = DM.main([
        "--dataset", "synthetic", "--model", model, "--renderable", "--epochs", str(epochs),
        "--batch-size", "4", "--image-size", "96", "--lr", "2e-3",
        "--lr-steps", str(int(epochs * 0.7)), str(int(epochs * 0.85)),
        "--output-dir", os.path.join(ARTIFACTS, "runs", tag), "--seed", "0",
        "--device", device,
    ])
    if state is None:
        raise RuntimeError(f"{tag} artifact training aborted (NaN loss)")
    _save(os.path.join(ARTIFACTS, f"synthetic_{tag}.pt"), unwrapped(state.model).state_dict(),
          {"model": model, "num_classes": num_classes, "image_size": 96, "epochs": epochs})


def train_frcnn(epochs: int = 40, device: str = "cuda"):
    """Faster R-CNN (full R50-FPN) on the renderable synthetic set."""
    _train_detection("fasterrcnn_resnet50_fpn", "frcnn", 5, epochs, device)


def train_maskrcnn(epochs: int = 24, device: str = "cuda"):
    """Mask R-CNN on the renderable synthetic set (rectangle masks = the box
    interiors); shorter than Faster R-CNN: its mAP plateaued by about
    epoch 20 in JAX."""
    _train_detection("maskrcnn_resnet50_fpn", "maskrcnn", 5, epochs, device)


def train_keypointrcnn(epochs: int = 24, device: str = "cuda"):
    """Keypoint R-CNN on the synthetic person-only set."""
    _train_detection("keypointrcnn_resnet50_fpn", "kprcnn", 2, epochs, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("overrides", nargs="*", help="config overrides for the YOLO run")
    ap.add_argument("--yolo", action="store_true")
    ap.add_argument("--frcnn", action="store_true")
    ap.add_argument("--maskrcnn", action="store_true")
    ap.add_argument("--kprcnn", action="store_true")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    explicit = args.yolo or args.frcnn or args.maskrcnn or args.kprcnn
    if args.yolo or not explicit:
        train_yolo(args.epochs, args.device, args.overrides)
    if args.frcnn:
        train_frcnn(args.epochs or 40, args.device)
    if args.maskrcnn:
        train_maskrcnn(args.epochs or 24, args.device)
    if args.kprcnn:
        train_keypointrcnn(args.epochs or 24, args.device)


if __name__ == "__main__":
    main()
