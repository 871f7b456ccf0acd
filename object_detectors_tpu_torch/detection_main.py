"""torchvision-style detection training / evaluation CLI (port of the JAX
package's ``detection_main.py``, the reference's
`torchvision_models/detection/train.py`).

The reference CLI surface (train.py:208-270): dataset selection (coco /
coco_kp / lvis / synthetic), the model factory of ``--model``
(``ModelAdapter``: ``fasterrcnn_resnet50_fpn``, ``maskrcnn_resnet50_fpn``,
``keypointrcnn_resnet50_fpn``, ``retinanet_resnet50_fpn`` and
``ssd300_vgg16``), SGD with multistep decay and linear warmup
(detection/utils.py:239-247), the tf-idf wiring (``--tfidf`` column,
``--tfidf-norm``, ``--classif``, ``--csl`` class weights,
train.py:103-135), ``--resume``, ``--test-only`` with a detections JSON
dump, and the epoch loop train -> checkpoint -> evaluate (engine.py:13-109).
Runs on the card unless ``--device cpu`` is given.

Images are resized on the host into a fixed square canvas (the min/max-size
rule of GeneralizedRCNNTransform), GT padded (``rcnn_batches``); with
``--device-ingest`` the host only decodes and the resize and normalize run
on the device.

In place of the JAX ``init_variables`` the adapter builds the torch module
with seeded random weights (a ``torch.Generator`` seeded with ``seed``, on
the CPU, at the Flax initializers' scales) and moves it to ``device``.
``losses`` puts the model in training mode (no fused eval blocks) and
returns the loss dict; ``detect`` runs it in eval mode without autograd. GT
labels are 1-based with 0 the background; RetinaNet's loss takes them
0-based (``clamp(labels - 1, 0)``) and its ``detect`` returns them 1-based
again.

The two-stage samplers draw from a generator seeded from (seed, epoch *
100003 + step), as JAX folds that index into its key; a checkpoint also
holds the host augmentation generator's state, so that a resumed run draws
what an uninterrupted one would.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from object_detectors_tpu_torch._device import resolve_device
from object_detectors_tpu_torch.data import coco as data_coco
from object_detectors_tpu_torch.data import idf as idf_lib
from object_detectors_tpu_torch.data import transforms as T
from object_detectors_tpu_torch.eval import evaluator as eval_lib
from object_detectors_tpu_torch.kernels.preprocess import rcnn_resize_normalize_from_canvas
from object_detectors_tpu_torch.models import anchors as anchor_lib
from object_detectors_tpu_torch.models import faster_rcnn as FR
from object_detectors_tpu_torch.models import keypoint_rcnn as KR
from object_detectors_tpu_torch.models import mask_rcnn as MR
from object_detectors_tpu_torch.models import retinanet as RN
from object_detectors_tpu_torch.models import ssd as SSD
from object_detectors_tpu_torch.models.roi_heads import RoIHeadsConfig
from object_detectors_tpu_torch.models.rpn import RPNConfig
from object_detectors_tpu_torch.parallel import mesh
from object_detectors_tpu_torch.train import checkpoint as ckpt_lib
from object_detectors_tpu_torch.train import optim as optim_lib
from object_detectors_tpu_torch.train import trainer
from object_detectors_tpu_torch.utils import logging as log_lib

log = logging.getLogger("detection")

TWO_STAGE = ("fasterrcnn_resnet50_fpn", "maskrcnn_resnet50_fpn", "keypointrcnn_resnet50_fpn")
MODELS = TWO_STAGE + ("retinanet_resnet50_fpn", "ssd300_vgg16")


def rcnn_batches(dataset, batch_size, canvas: int, max_boxes=100, shuffle=False, seed=0,
                 min_size=800, max_size=1333, process_index=0, process_count=1,
                 hflip_rng=None, with_masks=False, with_keypoints=False,
                 augmentation="hflip", ar_group_factor=-1, device_ingest=False,
                 native_canvas=None):
    """Padded R-CNN batches: normalized images on a fixed square canvas,
    GT as absolute xyxy + 1-based labels (background = 0). Numpy, the
    batches of the JAX ``rcnn_batches`` bit for bit.

    with_masks: rasterize 'segmentation' annotations to canvas-resolution
    [B, M, canvas, canvas] float masks (box-shaped where absent).
    augmentation: preset policy applied when hflip_rng is given
    (presets.py:5-38): 'hflip', 'ssd' (photometric + zoom-out + IoU crop +
    hflip), 'ssdlite' (IoU crop + hflip); the crop/zoom presets skip mask
    and keypoint batches. ar_group_factor >= 0 enables aspect-ratio grouped
    batching (train.py:83-85). device_ingest: images come as a uint8
    native-resolution canvas [B, nc, nc, 3] with their true ``sizes`` and
    per-image ``min_sizes``; the resize, normalize and pad run on the
    device (``rcnn_resize_normalize_from_canvas``), GT, masks, keypoints and
    scales are computed on the host with the scale formula the device
    replays. ``native_canvas`` defaults to the dataset's largest image side
    (larger images are downscaled on the host to fit)."""
    if device_ingest and native_canvas is None:
        infos = [dataset._images[i] for i in dataset.ids]
        native_canvas = max(max(d["height"], d["width"]) for d in infos)
    order = data_coco.shard_indices(len(dataset), process_index, process_count, shuffle, seed)
    if ar_group_factor is not None and ar_group_factor >= 0:
        from object_detectors_tpu_torch.data import grouping

        ars = grouping.dataset_aspect_ratios(dataset)[order]
        gids = grouping.group_ids(ars, grouping.aspect_ratio_bins(ar_group_factor))
        batch_lists = [[int(order[i]) for i in bl]
                       for bl in grouping.grouped_batch_indices(gids, batch_size,
                                                                shuffle=False)]
    else:
        batch_lists = [order[i0:i0 + batch_size].tolist()
                       for i0 in range(0, len(order), batch_size)]

    def produce(idx_list):
        imgs, bxs, lbs, vds, ids, scales, msks, kplist, szs, mslist = ([] for _ in range(10))
        for idx in idx_list:
            image, tgt = dataset[int(idx)]
            boxes = tgt["boxes_xywh"].copy()
            if boxes.size:
                boxes[:, 2:] += boxes[:, :2]  # -> xyxy
            labels = tgt["labels"] + 1  # 1-based, 0 = background
            kps = tgt.get("keypoints") if with_keypoints else None
            if with_keypoints and kps is None:
                kps = np.zeros((len(boxes), 17, 3), np.float32)
            masks = None
            if with_masks:
                from object_detectors_tpu_torch.data import masks as mask_lib

                anns = dataset._anns_by_image.get(tgt["image_id"], [])
                h0, w0 = image.shape[:2]
                if anns and "segmentation" in anns[0]:
                    masks = mask_lib.masks_for_annotations(anns, h0, w0)
                else:  # box-shaped masks
                    masks = np.zeros((len(boxes), h0, w0), np.float32)
                    for i_b, bb in enumerate(boxes):
                        x1, y1, x2, y2 = [int(round(v)) for v in bb]
                        masks[i_b, max(y1, 0):y2, max(x1, 0):x2] = 1.0
            if (hflip_rng is not None and masks is None and kps is None
                    and augmentation in ("ssd", "ssdlite")):
                if augmentation == "ssd":
                    image = T.photometric_distort(hflip_rng, image)
                    if hflip_rng.rand() < 0.5:
                        image, boxes = T.random_zoom_out(hflip_rng, image, boxes)
                image, boxes, labels = T.random_iou_crop(hflip_rng, image, boxes, labels)
            if hflip_rng is not None and hflip_rng.rand() < 0.5:
                w0_flip = image.shape[1]
                image, boxes = T.hflip(image, boxes)
                if masks is not None:
                    masks = masks[:, :, ::-1].copy()
                if kps is not None and len(kps):
                    kps = T.hflip_keypoints(np.asarray(kps, np.float32), w0_flip)
            # a random min-size choice in training when a tuple is given
            # (transform.py:150-173); eval takes the last entry
            ms = min_size
            if isinstance(min_size, (tuple, list)):
                ms = (min_size[hflip_rng.randint(len(min_size))] if hflip_rng is not None
                      else min_size[-1])
            if device_ingest:
                h0, w0 = image.shape[:2]
                hr_x = hr_y = 1.0  # host pre-downscale factors
                if h0 > native_canvas or w0 > native_canvas:
                    r = min(native_canvas / h0, native_canvas / w0)
                    nh0, nw0 = max(int(h0 * r), 1), max(int(w0 * r), 1)
                    from PIL import Image

                    image = np.asarray(Image.fromarray(image.astype(np.uint8)).resize(
                        (nw0, nh0), Image.BILINEAR))
                    # per axis: int() truncation makes nh0/h0 != nw0/w0
                    hr_y, hr_x = nh0 / h0, nw0 / w0
                    if boxes.size:
                        boxes = boxes * np.array([hr_x, hr_y, hr_x, hr_y], np.float32)
                    if kps is not None and len(kps):
                        kps = np.asarray(kps, np.float32).copy()
                        kps[..., 0] *= hr_x
                        kps[..., 1] *= hr_y
                    h0, w0 = nh0, nw0
                scale = min(T.min_max_resize_factor(h0, w0, ms, max_size),
                            canvas / h0, canvas / w0)
                img = np.zeros((native_canvas, native_canvas, 3), np.uint8)
                img[:h0, :w0] = image.astype(np.uint8)
                sboxes = (boxes.astype(np.float32) * scale if boxes.size
                          else np.zeros((0, 4), np.float32))
                # masks and keypoints live in the device-resized coordinates:
                # round(native * scale), half to even on both sides
                content_size = (int(np.round(h0 * scale)), int(np.round(w0 * scale)))
                szs.append((h0, w0))
                mslist.append(float(ms))
                inv_sx, inv_sy = 1.0 / (scale * hr_x), 1.0 / (scale * hr_y)
            else:
                padded, sboxes, true_size, scale = T.rcnn_resize(
                    image, boxes, min_size=ms, max_size=max_size, pad_to=(canvas, canvas))
                # normalize before padding like the reference (transform.py
                # :129-138 then batch_images :208-226): the pad is 0 after
                # normalization
                img = T.normalize_image(padded)
                img[true_size[0]:] = 0.0
                img[:, true_size[1]:] = 0.0
                content_size = true_size
                inv_sx = inv_sy = 1.0 / scale
            b, l, v = T.pad_targets(sboxes, labels, max_boxes)
            if kps is not None:
                kp = np.asarray(kps, np.float32).copy()
                kpad = np.zeros((max_boxes, kp.shape[1] if kp.size else 17, 3), np.float32)
                if kp.size:
                    kp[..., :2] *= scale  # follow the image resize
                    n_k = min(len(kp), max_boxes)
                    kpad[:n_k] = kp[:n_k]
                kplist.append(kpad)
            if masks is not None:
                mpad = np.zeros((max_boxes, canvas, canvas), np.float32)
                nh, nw = content_size
                for i_m in range(min(len(masks), max_boxes)):
                    mpad[i_m, :nh, :nw] = T._resize(masks[i_m], (nw, nh), "INTER_NEAREST",
                                                    "NEAREST")
                msks.append(mpad)
            imgs.append(img)
            bxs.append(b)
            lbs.append(l)
            vds.append(v)
            ids.append(tgt["image_id"])
            scales.append((inv_sx, inv_sy))
        while len(imgs) < batch_size:
            imgs.append(imgs[-1])
            bxs.append(bxs[-1])
            lbs.append(lbs[-1])
            vds.append(np.zeros_like(vds[-1]))
            ids.append(-1)
            scales.append(scales[-1])
            for extra in (msks, kplist):
                if extra:
                    extra.append(np.zeros_like(extra[-1]))
            for extra in (szs, mslist):
                if extra:
                    extra.append(extra[-1])
        out = {
            "images": np.stack(imgs) if device_ingest else np.stack(imgs).astype(np.float32),
            "gt_boxes": np.stack(bxs),
            "gt_labels": np.stack(lbs).astype(np.int32),
            "gt_valid": np.stack(vds),
            "image_ids": np.array(ids, np.int64),
            "scale_factors": np.array(scales, np.float32),
        }
        if device_ingest:
            out["sizes"] = np.array(szs, np.int32)
            out["min_sizes"] = np.array(mslist, np.float32)
        if msks:
            out["gt_masks"] = np.stack(msks)
        if kplist:
            out["gt_keypoints"] = np.stack(kplist)
        return out

    yield from data_coco._prefetched(produce, batch_lists, 2)


class ModelAdapter:
    """Build, loss and detections of one architecture."""

    def __init__(self, name: str, num_classes: int, image_size: int, loss_type: str = "ce",
                 tfidf=1.0, resnet_layers=(3, 4, 6, 3), small: bool = False,
                 class_weights=None, tfidf_mini_batch: bool = False, tfidf_norm: int = 0,
                 device: str | torch.device = "cuda", seed: int = 0):
        if name not in MODELS:
            raise ValueError(name)
        self.name = name
        self.image_size = image_size
        self.device = resolve_device(device)
        # the two-stage models take tfidf as a vector (None = off)
        vector = np.ndim(tfidf) > 0
        self.tfidf = (torch.as_tensor(np.asarray(tfidf), dtype=torch.float32, device=self.device)
                      if vector else tfidf)
        self.tfidf_vec = self.tfidf if vector else None
        self.class_weights = (None if class_weights is None else torch.as_tensor(
            np.asarray(class_weights), dtype=torch.float32, device=self.device))
        rpn_cfg = RPNConfig() if not small else RPNConfig(
            pre_nms_top_n_train=64, pre_nms_top_n_test=64, post_nms_top_n_train=32,
            post_nms_top_n_test=16, batch_size_per_image=32)
        roi_cfg = RoIHeadsConfig(
            num_classes=num_classes, loss_type=loss_type, tfidf_mini_batch=tfidf_mini_batch,
            tfidf_norm=tfidf_norm,
            **({"batch_size_per_image": 16, "detections_per_img": 10} if small else {}))
        layers = tuple(resnet_layers)
        if name == "fasterrcnn_resnet50_fpn":
            model = FR.init_frcnn_(FR.FasterRCNN(FR.FasterRCNNConfig(
                num_classes=num_classes, rpn=rpn_cfg, roi=roi_cfg, resnet_layers=layers)), seed)
        elif name == "maskrcnn_resnet50_fpn":
            model = MR.init_maskrcnn_(MR.MaskRCNN(MR.MaskRCNNConfig(
                num_classes=num_classes, rpn=rpn_cfg, roi=roi_cfg, resnet_layers=layers)), seed)
        elif name == "keypointrcnn_resnet50_fpn":
            model = KR.init_kprcnn_(KR.KeypointRCNN(KR.KeypointRCNNConfig(
                num_classes=num_classes, rpn=rpn_cfg, roi=roi_cfg, resnet_layers=layers,
                kp_head_layers=2 if small else 8, kp_head_features=64 if small else 512)), seed)
        elif name == "retinanet_resnet50_fpn":
            self.cfg = RN.RetinaNetConfig(num_classes=num_classes,
                                          tfidf_mini_batch=tfidf_mini_batch,
                                          tfidf_norm=tfidf_norm)
            model = RN.init_retinanet_(RN.RetinaNet(num_classes, layers), seed)
        else:
            self.cfg = SSD.SSDConfig(num_classes=num_classes, tfidf_mini_batch=tfidf_mini_batch,
                                     tfidf_norm=tfidf_norm)
            model = SSD.init_ssd_(SSD.SSD300(self.cfg), seed)
        self.model = model.to(self.device)
        self._anchors: dict = {}

    def _anchors_for(self) -> torch.Tensor:
        """RetinaNet's anchors: the ceil-chain grids of P3-P7, not s // stride."""
        if "retinanet" not in self._anchors:
            s = self.image_size
            sizes, ars = anchor_lib.retinanet_anchor_config()
            self._anchors["retinanet"] = torch.from_numpy(anchor_lib.grid_anchors(
                (s, s), anchor_lib.fpn_grid_sizes((s, s)), sizes, ars)).to(self.device)
        return self._anchors["retinanet"]

    def _ssd_anchors(self, level_sizes) -> torch.Tensor:
        """SSD's default boxes for the head's anchors per level."""
        key = tuple(level_sizes)
        if key not in self._anchors:
            grids = [(int(np.sqrt(ls / a)),) * 2
                     for ls, a in zip(level_sizes, SSD.ANCHORS_PER_LOCATION)]
            self._anchors[key] = torch.from_numpy(anchor_lib.ssd_default_boxes(
                (self.image_size, self.image_size), grids)).to(self.device)
        return self._anchors[key]

    def losses(self, batch: dict, generator: torch.Generator | None = None,
               uniforms=None) -> dict:
        """The loss dict of a batch (``images`` [B, H, W, 3] normalized,
        ``gt_boxes`` [B, M, 4], ``gt_labels`` [B, M] 1-based, ``gt_valid``
        [B, M]; ``gt_masks`` [B, M, H, W] for Mask R-CNN and
        ``gt_keypoints`` [B, M, K, 3] for Keypoint R-CNN, zeros when
        absent). The two-stage samplers draw from ``generator`` or take
        ``uniforms`` (``FasterRCNN.forward``)."""
        model = self.model.train()
        imgs = batch["images"]
        gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
        if self.name in TWO_STAGE:
            b, m = gt[1].shape
            if self.name == "maskrcnn_resnet50_fpn":
                gm = batch.get("gt_masks")
                gt += (gm if gm is not None else imgs.new_zeros((b, m) + imgs.shape[1:3]),)
            elif self.name == "keypointrcnn_resnet50_fpn":
                gkp = batch.get("gt_keypoints")
                gt += (gkp if gkp is not None else imgs.new_zeros((b, m, 17, 3)),)
            return model(imgs, *gt, train=True, tfidf=self.tfidf_vec,
                         class_weights=self.class_weights, generator=generator,
                         uniforms=uniforms)
        if self.name == "retinanet_resnet50_fpn":
            cls, reg, _ = model(imgs, train=True)
            return RN.retinanet_loss(cls.float(), reg.float(), self._anchors_for(), gt[0],
                                     (gt[1] - 1).clamp(min=0), gt[2], self.cfg,
                                     tfidf=self.tfidf)
        cls, reg, level_sizes = model(imgs)
        return SSD.ssd_loss(cls.float(), reg.float(), self._ssd_anchors(level_sizes), *gt,
                            self.cfg, tfidf=self.tfidf)

    # an evaluation runs the module inside DDP: each rank on its own images,
    # without a collective
    @torch.no_grad()
    def _eval(self, images: torch.Tensor):
        return ckpt_lib.unwrapped(self.model).eval()(images, tfidf=self.tfidf_vec)

    @torch.no_grad()
    def detect(self, images: torch.Tensor):
        """images [B, H, W, 3] normalized -> (boxes [B, D, 4], scores,
        labels 1-based, valid)."""
        s = self.image_size
        if self.name in TWO_STAGE:
            return self._eval(images)[:4]
        model = ckpt_lib.unwrapped(self.model).eval()
        cls, reg, level_sizes = model(images)
        if self.name == "retinanet_resnet50_fpn":
            b, sc, lab, v = RN.retinanet_postprocess(cls, reg, self._anchors_for(),
                                                     tuple(level_sizes), (s, s), self.cfg,
                                                     tfidf_post=self.tfidf)
            return b, sc, lab + 1, v  # 1-based for the evaluator
        return SSD.ssd_postprocess(cls.float(), reg.float(), self._ssd_anchors(level_sizes),
                                   (s, s), self.cfg, tfidf_post=self.tfidf)

    def detect_with_masks(self, images: torch.Tensor):
        """Mask R-CNN only: (boxes, scores, labels, valid, masks [B, D, 28,
        28] probabilities)."""
        if self.name != "maskrcnn_resnet50_fpn":
            raise ValueError(f"detect_with_masks needs maskrcnn_resnet50_fpn, not {self.name}")
        return self._eval(images)

    def detect_with_keypoints(self, images: torch.Tensor):
        """Keypoint R-CNN only: (boxes, scores, labels, valid, keypoints
        [B, D, K, 3], kp_scores [B, D, K])."""
        if self.name != "keypointrcnn_resnet50_fpn":
            raise ValueError(f"detect_with_keypoints needs keypointrcnn_resnet50_fpn, "
                             f"not {self.name}")
        return self._eval(images)


def _class_vector(tables: dict, column, num_classes: int) -> np.ndarray:
    """An idf table column laid out by category id, ones elsewhere."""
    vec = np.ones(num_classes, np.float32)
    for i, cid in enumerate(tables["_kept_category_ids"]):
        if cid < num_classes:
            vec[cid] = column[i]
    return vec


def build_tfidf_vector(args, gt_train, num_classes):
    """train.py:103-135: the idf table column ``args.tfidf``, optionally
    normalized: a [num_classes] logit-scale vector, or 1.0."""
    if not args.tfidf:
        return 1.0
    tables = idf_lib.idf_tables(gt_train)
    col = tables.get(args.tfidf)
    if col is None:
        raise SystemExit(f"unknown tfidf column {args.tfidf}")
    vec = _class_vector(tables, col, num_classes)
    if args.tfidf_norm:
        vec = vec / np.linalg.norm(vec, ord=args.tfidf_norm)
    return vec


def build_csl_weights(args, gt_train, num_classes):
    """train.py:121-135: CSL classification weights. 'eff_samp' builds
    effective-number weights (1-b)/(1-b^n) from instance_freq with weight 1
    at background; any other value picks an idf table column; None
    disables."""
    if not args.csl:
        return None
    tables = idf_lib.idf_tables(gt_train)
    kept = tables["_kept_category_ids"]
    if args.csl == "eff_samp":
        freq = np.zeros(num_classes, np.float64)
        for i, cid in enumerate(kept):
            if cid < num_classes:
                freq[cid] = tables["instance_freq"][i]
        beta = 0.9999
        eff = 1.0 - np.power(beta, freq)
        w = np.where(eff > 0, (1.0 - beta) / np.maximum(eff, 1e-12), 1.0)
        w[0] = 1.0  # background stays unweighted (train.py:128)
        return w.astype(np.float32)
    col = tables.get(args.csl)
    if col is None:
        raise SystemExit(f"unknown csl column {args.csl}")
    return _class_vector(tables, col, num_classes)


def _ingest_images(batch: dict, image_size: int, min_size, max_size: int,
                   min_sizes=None) -> torch.Tensor:
    """The device-ingest resize of a batch's uint8 canvas (``sizes``; the
    drawn ``min_sizes`` in training)."""
    images, _, _ = rcnn_resize_normalize_from_canvas(
        batch["images"], batch["sizes"], (image_size, image_size), min_size=min_size,
        max_size=max_size, min_sizes=min_sizes)
    return images


def evaluate(adapter: ModelAdapter, dataset, gt: dict, batch_size: int, max_boxes: int = 100,
             min_size=800, max_size: int = 1333, device_ingest: bool = False):
    """engine.evaluate parity: the detections of ``adapter`` on ``dataset``
    scored as bbox (+ segm for Mask R-CNN, + keypoints OKS for Keypoint
    R-CNN, engine._get_iou_types). Returns (bbox mAP, evaluator, extra),
    extra = (iou type, its 12 stats) or None."""
    dev = adapter.device
    eval_masks = adapter.name == "maskrcnn_resnet50_fpn"
    eval_kps = adapter.name == "keypointrcnn_resnet50_fpn"
    detect = (adapter.detect_with_masks if eval_masks else
              adapter.detect_with_keypoints if eval_kps else adapter.detect)
    ev = eval_lib.DetectionEvaluator(gt, label_map=lambda c: c)
    for batch in rcnn_batches(dataset, batch_size, adapter.image_size, max_boxes,
                              min_size=min_size, max_size=max_size,
                              process_index=mesh.process_index(),
                              process_count=mesh.process_count(),
                              device_ingest=device_ingest):
        t = {k: torch.from_numpy(batch[k]).to(dev) for k in ("images", "sizes") if k in batch}
        eval_min = min_size[-1] if isinstance(min_size, (tuple, list)) else min_size
        images = (_ingest_images(t, adapter.image_size, eval_min, max_size)
                  if device_ingest else t["images"])
        out = detect(images)
        keep = batch["image_ids"] >= 0
        sel = torch.from_numpy(keep).to(dev)
        extra = {"masks": out[4][sel]} if eval_masks else (
            {"keypoints": out[4][sel]} if eval_kps else {})
        ev.update(batch["image_ids"][keep], *(o[sel] for o in out[:4]),
                  batch["scale_factors"][keep], **extra)
    ev.synchronize_between_processes()
    stats = ev.summarize()
    extra = None
    if eval_masks:
        extra = ("segm", ev.summarize("segm"))
    elif eval_kps:
        extra = ("keypoints", ev.summarize("keypoints"))
    return float(stats[0]), ev, extra


def synthetic_datasets(model: str, renderable: bool):
    """detection_main's synthetic sets: 16 train and 8 val images of 96²
    (seeds 0 and 1; person-only with keypoints for Keypoint R-CNN, with
    segmentations for Mask R-CNN), noise images or drawn class-colored
    boxes. Returns (train_ds, val_ds, num_classes with the background)."""
    from object_detectors_tpu_torch.data import synthetic

    with_segm = model == "maskrcnn_resnet50_fpn"
    with_kp = model == "keypointrcnn_resnet50_fpn"
    n_cls = 1 if with_kp else 4  # coco_kp is person-only
    sets = [synthetic.make_coco_dicts(np.random.RandomState(seed), n, 96, n_cls,
                                      with_segmentation=with_segm, with_keypoints=with_kp)
            for seed, n in ((0, 16), (1, 8))]
    out = []
    for g in sets:
        imgs = {im["id"]: (synthetic.render_image(g, im["id"]) if renderable else
                           np.random.RandomState(im["id"]).randint(0, 255, (96, 96, 3))
                           .astype(np.uint8)) for im in g["images"]}
        out.append(data_coco.CocoDetectionDataset(
            g, label_mode="lvis0", image_loader=lambda info, imgs=imgs: imgs[info["id"]]))
    return out[0], out[1], n_cls + 1


def _rng_state(rng: np.random.RandomState) -> dict:
    name, keys, pos, has_gauss, gauss = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "gauss": float(gauss)}


def _set_rng_state(rng: np.random.RandomState, state: dict) -> None:
    rng.set_state(("MT19937", state["keys"].numpy().astype(np.uint32), state["pos"],
                   state["has_gauss"], state["gauss"]))


def _save(ckpt, tag, state, epoch, metric, hflip_rng):
    if mesh.process_index() != 0:
        return
    ckpt.save_raw(tag, {**ckpt_lib.state_payload(state), "hflip_rng": _rng_state(hflip_rng)},
                  epoch, {"mAP": metric})


def _restore(ckpt, tag, state, hflip_rng):
    """Restore ``tag`` into ``state`` and ``hflip_rng``; returns the epoch to
    start from, or None when the tag is absent."""
    out = ckpt.restore_raw(tag)
    if out is None:
        return None
    payload, epoch, _metrics = out
    ckpt_lib.load_state_payload(state, payload)
    if "hflip_rng" in payload:
        _set_rng_state(hflip_rng, payload["hflip_rng"])
    return epoch + 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="synthetic",
                    choices=["coco", "coco_kp", "lvis", "synthetic"])
    ap.add_argument("--data-path", default="datasets/coco")
    ap.add_argument("--model", default="retinanet_resnet50_fpn", choices=list(MODELS))
    ap.add_argument("--epochs", type=int, default=26)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.02 / 8)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--lr-steps", type=int, nargs="+", default=[16, 22])
    ap.add_argument("--lr-gamma", type=float, default=0.1)
    ap.add_argument("--image-size", type=int, default=800)
    ap.add_argument("--max-boxes", type=int, default=100)
    ap.add_argument("--tfidf", default=None,
                    help="idf column name, e.g. smooth / raw / gombit")
    ap.add_argument("--tfidf-norm", type=int, default=0)
    ap.add_argument("--tfidf_mini_batch", "--tfidf-mini-batch", action="store_true",
                    dest="tfidf_mini_batch", help="recompute tfidf per minibatch (train.py:246)")
    ap.add_argument("--csl", default=None,
                    help="cost-sensitive class weights: 'eff_samp' or an idf column "
                         "(train.py:121-135)")
    ap.add_argument("--classif", default="ce",
                    choices=["ce", "bce", "focal_loss", "gombit", "gombit_fl"])
    ap.add_argument("--data-augmentation", default="hflip", choices=["hflip", "ssd", "ssdlite"],
                    help="train augmentation preset (presets.py:5-38)")
    ap.add_argument("--aspect-ratio-group-factor", type=int, default=3,
                    help="AR-grouped batching bins (train.py:83-85); -1 disables")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--test-only", action="store_true")
    ap.add_argument("--output-dir", default="output/detection")
    ap.add_argument("--dump-json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true", help="tiny model/backbone for smoke runs")
    ap.add_argument("--device-ingest", action="store_true",
                    help="the host decodes to a uint8 native canvas; the resize, normalize "
                         "and pad run on the device")
    ap.add_argument("--renderable", action="store_true",
                    help="synthetic images with drawn class-colored boxes (learnable signal) "
                         "instead of noise")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    os.makedirs(args.output_dir, exist_ok=True)
    mesh.maybe_initialize_distributed()
    device = resolve_device(args.device)

    if args.dataset == "synthetic":
        train_ds, val_ds, num_classes = synthetic_datasets(args.model, args.renderable)
        min_size, max_size = args.image_size, args.image_size * 2
    else:
        root = args.data_path
        # dataset registry (train.py:47-51: coco 91 / coco_kp 2 / lvis)
        split = {"coco": ("instances_train2017.json", "instances_val2017.json"),
                 "coco_kp": ("person_keypoints_train2017.json",
                             "person_keypoints_val2017.json"),
                 "lvis": ("lvis_v1_train.json", "lvis_v1_val.json")}[args.dataset]
        # lvis0 maps category ids to 0-based; rcnn_batches' +1 restores the
        # raw 1-based ids the torchvision models train on
        train_ds = data_coco.CocoDetectionDataset(
            os.path.join(root, "annotations", split[0]), os.path.join(root, "train2017"),
            label_mode="lvis0")
        val_ds = data_coco.CocoDetectionDataset(
            os.path.join(root, "annotations", split[1]), os.path.join(root, "val2017"),
            label_mode="lvis0")
        num_classes = {"coco": 91, "coco_kp": 2, "lvis": 1204}[args.dataset]
        min_size, max_size = 800, 1333
    gt_train, gt_val = train_ds.gt, val_ds.gt

    adapter = ModelAdapter(
        args.model, num_classes, args.image_size, loss_type=args.classif,
        tfidf=build_tfidf_vector(args, gt_train, num_classes),
        resnet_layers=(1, 1, 1, 1) if args.small else (3, 4, 6, 3), small=args.small,
        class_weights=build_csl_weights(args, gt_train, num_classes),
        tfidf_mini_batch=args.tfidf_mini_batch, tfidf_norm=args.tfidf_norm, device=device,
        seed=args.seed)
    batch_size = mesh.per_process_batch(args.batch_size)
    adapter.model = mesh.data_parallel(adapter.model)
    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    tx = optim_lib.make_optimizer(
        optim_lib.OptimizerConfig("sgd", args.lr, args.weight_decay, args.momentum),
        optim_lib.SchedulerConfig("multistep", milestones=tuple(args.lr_steps),
                                  factor=args.lr_gamma,
                                  warmup_steps=min(1000, steps_per_epoch),
                                  warmup_factor=1.0 / 1000),
        steps_per_epoch)
    state = trainer.create_detection_train_state(adapter, tx)
    ckpt = ckpt_lib.CheckpointManager(os.path.join(args.output_dir, "checkpoints"))
    hflip_rng = np.random.RandomState(args.seed + 7)
    start_epoch = 0
    if args.resume:
        start_epoch = _restore(ckpt, args.resume, state, hflip_rng) or 0

    def run_eval():
        return evaluate(adapter, val_ds, gt_val, batch_size, args.max_boxes, min_size,
                        max_size, args.device_ingest)

    if args.test_only:
        mAP, ev, extra = run_eval()
        if args.dump_json:
            ev.save_detections(args.dump_json)
        print(f"mAP: {mAP:.4f}")
        if extra is not None:
            print(f"{extra[0]} mAP: {float(extra[1][0]):.4f}")
        return mAP

    logger = log_lib.MetricLogger()
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        for i, batch in enumerate(rcnn_batches(
                train_ds, batch_size, args.image_size, args.max_boxes, shuffle=True,
                seed=args.seed + epoch, min_size=min_size, max_size=max_size,
                process_index=mesh.process_index(), process_count=mesh.process_count(),
                hflip_rng=hflip_rng, with_masks=args.model == "maskrcnn_resnet50_fpn",
                with_keypoints=args.model == "keypointrcnn_resnet50_fpn",
                augmentation=args.data_augmentation,
                ar_group_factor=args.aspect_ratio_group_factor,
                device_ingest=args.device_ingest)):
            t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                 if k not in ("image_ids", "scale_factors")}
            if args.device_ingest:
                t["images"] = _ingest_images(t, args.image_size, min_size, max_size,
                                             t.pop("min_sizes"))
                del t["sizes"]
            gen = trainer.draw_generator(args.seed, epoch * 100003 + i, device)
            state, total, losses = trainer.detection_train_step(state, adapter, t,
                                                                generator=gen)
            # each rank holds its share of the global losses: their mean is JAX's
            reduced = mesh.all_reduce_mean(torch.stack([total, *losses.values()])).tolist()
            total = reduced[0]
            if not np.isfinite(total):
                log.error("Loss is %s, stopping (engine.py:40-43)", total)
                return None
            logger.update(loss=total, **dict(zip(losses, reduced[1:])))
        mAP, _, extra = run_eval()
        _save(ckpt, f"model_{epoch}", state, epoch, mAP, hflip_rng)
        _save(ckpt, "last", state, epoch, mAP, hflip_rng)
        if extra is not None:
            log.info("epoch %d: %s mAP=%.4f", epoch, extra[0], float(extra[1][0]))
        log.info("epoch %d: %s mAP=%.4f (%.1fs)", epoch, logger, mAP, time.time() - t0)
    return state


if __name__ == "__main__":
    main()
