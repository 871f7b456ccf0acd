"""The port's data-parallel training at world size 2 over gloo on the CPU
(object_detectors_tpu_torch/parallel/mesh.py and batch_norm.py, the global
loss normalizers, detection_main's sharded evaluation, main.py's
checkpoints) against JAX's step on the whole batch, which the JAX package's
mesh step equals (tests/test_train_step.py::test_dp_matches_single_device).

Two worker processes (tests/torch_ddp_worker.py, no JAX) each take rows
rank, rank + 2, ... of every global batch, as the port's batch iterators
deal images out; the ranks' halves hold different GT counts, so a per-rank
normalizer would show. The parent starts them, computes the JAX reference
meanwhile and compares:

* the batch norm: forward, backward and running statistics against Flax's
  ``BatchNorm`` on the whole batch (float32 within 1e-5 / 1e-4; bfloat16
  within two bf16 ulps of the largest value);
* the tiny YOLO's ``yolo_train_step`` under DDP, one step in float32 and
  two in float64, against JAX's ``yolo_train_step``: the tolerances of
  tests/test_torch_train.py (metrics within rtol 1e-4, grad_norm within
  rtol 1e-3 in float32, each float64 update within UPDATE_SHARE of that
  tensor's largest);
* each loss normalizer (YOLO's GT and no-object counts, the RPN's and RoI
  heads' sampled counts, the weighted CE's weight sum, the mask and
  keypoint counts, SSD's foreground count, the minibatch idf's counts):
  the mean of the ranks' values against the JAX loss on the whole batch
  within rtol 1e-4, and each rank's gradient over 2 against JAX's at its
  rows;
* one ``detection_train_step`` of each detection_main architecture at
  world size 2 against the port's world-1 step on the same batch and
  sampler generator: losses within rtol 1e-4, each tensor's gradient
  within DETECTION_GRAD_SHARE of its largest (the float32 sums run in
  another order), the parameters after it bitwise equal on both ranks;
* ``detection_main.evaluate`` sharded over both ranks on a set of 7 images
  (the last rank's last image repeats the first) at 2 images a rank: each
  image scored once, the same detections (within SCORE_ATOL and BOX_ATOL)
  and the same mAP as one process at batch 2;
* ``main.train_pipeline``: only rank 0 writes checkpoints, and one epoch
  plus a resume ends bitwise where two epochs straight do.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.data import idf as jidf
from object_detectors_tpu.models import keypoint_rcnn as JKR
from object_detectors_tpu.models import mask_rcnn as JMR
from object_detectors_tpu.models import retinanet as JRN
from object_detectors_tpu.models import roi_heads as JRH
from object_detectors_tpu.models import rpn as JRPN
from object_detectors_tpu.models import ssd as JSSD
from object_detectors_tpu.models import yolo_criterion as JYC
from object_detectors_tpu.models.yolo import YoloHead as FlaxYoloHead
from object_detectors_tpu.train import optim as JO
from object_detectors_tpu.train import trainer as JT
from object_detectors_tpu_torch import detection_main as DM
from object_detectors_tpu_torch.models import anchors as A
from object_detectors_tpu_torch.models import retinanet as RN
from object_detectors_tpu_torch.models import roi_heads as RH
from object_detectors_tpu_torch.models import rpn as RPN
from object_detectors_tpu_torch.models import ssd as SSD
from object_detectors_tpu_torch.models import yolo_criterion as YC
from object_detectors_tpu_torch.train import optim as O
from object_detectors_tpu_torch.utils.weights import flax_yolo_to_torch
from test_torch_checkpoint import _payloads_equal
from test_torch_yolo import randomize_bn
import torch_ddp_worker as W

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().with_name("torch_ddp_worker.py")
WORLD = 2
# tests/test_torch_train.py's: two float64 steps, each tensor's update
UPDATE_SHARE = 1e-5
# a world-2 detection step's gradients against the world-1 step's in
# float32: the same arithmetic, its sums split over the ranks; each tensor's
# largest difference within DETECTION_GRAD_SHARE of its own largest
# gradient (6.2e-6 seen, SSD300's first conv) plus CANCEL_SHARE of the
# largest gradient of any tensor (Keypoint R-CNN's keypoint-logit bias takes
# no gradient in exact arithmetic and is left with float32 cancellation,
# 1.7e-8 of the largest seen)
DETECTION_GRAD_SHARE, CANCEL_SHARE = 1e-4, 1e-6
# the sharded evaluation's detections against one process's: the same
# images in other batches, float32 noise (7.5e-8 in a score and 1.7e-5 px
# in a box corner seen)
SCORE_ATOL, BOX_ATOL = 1e-6, 1e-3
NUM_CLASSES, IMG = 4, 64


def start(job: str, directory: Path, inp: dict) -> list:
    """Write the job's input and start its two ranks (one torch thread
    each, a file:// rendezvous in ``directory``)."""
    torch.save(inp, directory / f"{job}.in.pt")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]), "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, str(WORKER), job, str(directory), str(r),
                              str(WORLD)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]


def finish(job: str, directory: Path, procs: list, timeout: float = 300) -> list:
    """Wait for the ranks (killing them all if one fails or the time runs
    out) and return their outputs."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {job} exited {p.returncode}:\n{log[-6000:]}"
    return [torch.load(directory / f"{job}.out{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every job's two ranks, started at once so that they run while the
    parent computes the references: {job: (its directory, its processes,
    what the parent keeps)}. Ranks left running at the end are killed."""
    jobs = {}
    try:
        for job, make in (("ops", ops_job), ("detection", detection_job),
                          ("pipeline", pipeline_job), ("yolo", yolo_job)):
            directory = tmp_path_factory.mktemp(job)
            inp, keep = make(directory) if job == "pipeline" else make()
            jobs[job] = (directory, start(job, directory, inp), keep)
        yield jobs
    finally:
        for _, procs, _ in jobs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def whole(per_rank: list) -> np.ndarray:
    """Rows of the ranks (rank r's i-th row is row r + 2 i) in batch order."""
    out = np.empty((sum(len(a) for a in per_rank),) + tuple(per_rank[0].shape[1:]),
                   per_rank[0].dtype)
    for r, a in enumerate(per_rank):
        out[r::WORLD] = a
    return out


def port_config(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)})


# -- the batch norm and the loss normalizers ---------------------------------------

def bn_inputs():
    rng = np.random.RandomState(0)
    c = 6
    return {"x": (rng.randn(4, c, 5, 5) * 2 + 1).astype(np.float32),
            "dy": rng.randn(4, c, 5, 5).astype(np.float32),
            "weight": (rng.rand(c) + 0.5).astype(np.float32),
            "bias": (rng.randn(c) * 0.1).astype(np.float32),
            "running_mean": (rng.randn(c) * 0.1).astype(np.float32),
            "running_var": (rng.rand(c) + 0.5).astype(np.float32)}


def flax_bn(inp: dict, dtype):
    """Flax's train-mode BatchNorm (momentum 0.9, eps 1e-5) on the whole
    batch in ``dtype``: (y, dx, dscale, dbias, new mean, new var), NCHW."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=dtype)
    x = jnp.asarray(inp["x"].transpose(0, 2, 3, 1)).astype(dtype)
    variables = {"params": {"scale": jnp.asarray(inp["weight"]),
                            "bias": jnp.asarray(inp["bias"])},
                 "batch_stats": {"mean": jnp.asarray(inp["running_mean"]),
                                 "var": jnp.asarray(inp["running_var"])}}

    def f(params, x):
        return bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                        mutable=["batch_stats"])

    y, new = f(variables["params"], x)
    _, vjp = jax.vjp(lambda p, xx: f(p, xx)[0], variables["params"], x)
    dparams, dx = vjp(jnp.asarray(inp["dy"].transpose(0, 2, 3, 1)).astype(dtype))
    nchw = lambda a: np.asarray(a.astype(jnp.float32)).transpose(0, 3, 1, 2)  # noqa: E731
    return (nchw(y), nchw(dx), np.asarray(dparams["scale"]), np.asarray(dparams["bias"]),
            np.asarray(new["batch_stats"]["mean"]), np.asarray(new["batch_stats"]["var"]))


def batch_uniforms(key, b, n):
    """The two [b, n] uniforms JAX's samplers draw from split(key, b)."""
    per = []
    for k in jax.random.split(key, b):
        kp, kn = jax.random.split(k)
        per.append((np.asarray(jax.random.uniform(kp, (n,))),
                    np.asarray(jax.random.uniform(kn, (n,)))))
    return tuple(np.stack([p[i] for p in per]).astype(np.float32) for i in range(2))


def yolo_inputs(seed):
    """4 images, 6 GT slots; valid counts 3, 1, 2, 0: the ranks hold 5 and 1."""
    rng = np.random.RandomState(seed)
    grids = (2, 4, 8)
    p = sum(g * g * 3 for g in grids)
    raw = (rng.randn(4, p, 5 + NUM_CLASSES) * 1.5).astype(np.float32)
    boxes = np.concatenate([rng.rand(4, 6, 2) * 0.8 + 0.1, rng.rand(4, 6, 2) * 0.5 + 0.02],
                           -1).astype(np.float32)
    labels = rng.randint(0, NUM_CLASSES, (4, 6))
    valid = np.zeros((4, 6), bool)
    for i, n in enumerate((3, 1, 2, 0)):
        valid[i, :n] = True
    return grids, raw, boxes, labels, valid


YOLO_CASES = {"yolo ce weighted": {}, "yolo bce tfidf_batch": {
    "class_loss": JYC.CLASS_LOSS_BCE, "tfidf_batch": True, "tfidf_norm": 2},
    "yolo ce mean": {"reduction": "mean"}}


def loss_cases():
    """{name: (the worker's case, the JAX loss of the whole batch as a
    function of the differentiated arguments, returning (its values by
    name, the differentiable sum), those arguments)}."""
    cases = {}
    grids, raw, boxes, labels, valid = yolo_inputs(1)
    weights = (np.random.RandomState(2).rand(NUM_CLASSES) + 0.5).astype(np.float32)
    for name, extra in YOLO_CASES.items():
        cfg = JYC.YoloLossConfig(num_classes=NUM_CLASSES, img_size=IMG, **extra)
        pj, gj = JYC.make_priors(cfg, grids)
        pt, gt = YC.make_priors(port_config(YC.YoloLossConfig, cfg), grids)
        kw = {"class_weights": weights} if name.endswith("weighted") else {}

        def jax_yolo(r, cfg=cfg, pj=pj, gj=gj, kw=kw):
            loss, sub, stats = JYC.yolo_loss(r, pj, gj, jnp.asarray(boxes), jnp.asarray(labels),
                                             jnp.asarray(valid), cfg,
                                             **{k: jnp.asarray(v) for k, v in kw.items()})
            return {"0": loss, "1": sub, "2": stats}, loss + sub.sum()
        cases[name] = ({"fn": "yolo_loss", "args": [
            ("batch", raw), ("shared", pt.numpy()), ("shared", gt.numpy()), ("batch", boxes),
            ("batch", labels), ("batch", valid), ("shared", port_config(YC.YoloLossConfig, cfg))],
            "kwargs": kw, "grad": [0]}, jax_yolo, (raw,))

    # the RPN: 4 images, the last a background one
    rng = np.random.RandomState(4)
    a, m = 400, 4
    xy = rng.rand(a, 2) * 56
    anchors = np.concatenate([xy, xy + rng.rand(a, 2) * 24 + 2], -1).astype(np.float32)
    gxy = rng.rand(4, m, 2) * 40
    gtb = np.concatenate([gxy, gxy + rng.rand(4, m, 2) * 20 + 4], -1).astype(np.float32)
    gtb[:, :2] = anchors[rng.randint(0, a, (4, 2))]
    gvalid = rng.rand(4, m) < 0.8
    gvalid[:, 0] = True
    gvalid[3] = False
    obj = rng.randn(4, a).astype(np.float32)
    deltas = (rng.randn(4, a, 4) * 0.3).astype(np.float32)
    rpn_cfg = JRPN.RPNConfig(batch_size_per_image=64)
    key = jax.random.key(7)
    cases["rpn"] = ({"fn": "rpn_loss", "args": [
        ("batch", obj), ("batch", deltas), ("shared", anchors), ("batch", gtb), ("batch", gvalid),
        ("shared", port_config(RPN.RPNConfig, rpn_cfg)), ("pair", batch_uniforms(key, 4, a))],
        "grad": [0, 1]},
        lambda o, d: (lambda out: (dict(out), sum(out.values())))(JRPN.rpn_loss(
            o, d, jnp.asarray(anchors), jnp.asarray(gtb), jnp.asarray(gvalid), key, rpn_cfg)),
        (obj, deltas))

    # the RoI heads: sampled counts 11, 4, 9, 1 of 12
    rng = np.random.RandomState(5)
    s, c = 12, 5
    logits = (rng.randn(4, s, c) * 3).astype(np.float32)
    reg = rng.randn(4, s, 4 * c).astype(np.float32)
    rlabels = rng.randint(0, c, (4, s))
    targets = rng.randn(4, s, 4).astype(np.float32)
    sampled = np.arange(s)[None] < np.array([11, 4, 9, 1])[:, None]
    cw = (rng.rand(c) + 0.5).astype(np.float32)
    for loss_type in ("ce", "bce"):
        roi_cfg = JRH.RoIHeadsConfig(num_classes=c, loss_type=loss_type)
        cases[f"fastrcnn {loss_type}"] = ({"fn": "fastrcnn_loss", "args": [
            ("batch", logits), ("batch", reg), ("batch", rlabels), ("batch", targets),
            ("batch", sampled), ("shared", port_config(RH.RoIHeadsConfig, roi_cfg)),
            ("shared", cw)], "grad": [0, 1]},
            lambda lg, rg, roi_cfg=roi_cfg: (lambda out: (dict(out), sum(out.values())))(
                JRH.fastrcnn_loss(lg, rg, jnp.asarray(rlabels), jnp.asarray(targets),
                                  jnp.asarray(sampled), roi_cfg, jnp.asarray(cw))),
            (logits, reg))

    # the mask loss: positives 9, 2, 6, 0 of 10
    rng = np.random.RandomState(6)
    s, m, size = 10, 3, 40
    masks = (rng.rand(4, m, size, size) < 0.4).astype(np.float32)
    xy = rng.rand(4, s, 2) * size - 6
    mboxes = np.concatenate([xy, xy + 1 + rng.rand(4, s, 2) * size * 0.8], -1).astype(np.float32)
    matched = rng.randint(0, m, (4, s))
    mlabels = rng.randint(0, 4, (4, m))
    pos = np.arange(s)[None] < np.array([9, 2, 6, 0])[:, None]
    mlogits = (rng.randn(4, s, 28, 28, 4) * 3).astype(np.float32)
    cases["mask"] = ({"fn": "maskrcnn_loss", "args": [
        ("batch", mlogits), ("batch", mboxes), ("batch", masks), ("batch", mlabels),
        ("batch", matched), ("batch", pos)], "grad": [0]},
        lambda lg: (lambda v: ({"0": v}, v))(JMR.maskrcnn_loss(
            lg, *[jnp.asarray(t) for t in (mboxes, masks, mlabels, matched, pos)])),
        (mlogits,))

    # the keypoint loss: positives 8, 1, 5, 3 of 10
    rng = np.random.RandomState(7)
    k = 5
    xy = rng.rand(4, s, 2) * 50
    kboxes = np.concatenate([xy, xy + 3 + rng.rand(4, s, 2) * 60], -1).astype(np.float32)
    lo = rng.rand(4, m, 1, 2) * 50
    kps = np.concatenate([lo + rng.rand(4, m, k, 2) * 60, (rng.rand(4, m, k, 1) < 0.8) * 2.0],
                         -1).astype(np.float32)
    kmatched = rng.randint(0, m, (4, s))
    kpos = np.arange(s)[None] < np.array([8, 1, 5, 3])[:, None]
    klogits = (rng.randn(4, s, 56, 56, k) * 2).astype(np.float32)
    cases["keypoint"] = ({"fn": "keypointrcnn_loss", "args": [
        ("batch", klogits), ("batch", kboxes), ("batch", kps), ("batch", kmatched),
        ("batch", kpos)], "grad": [0]},
        lambda lg: (lambda v: ({"0": v}, v))(JKR.keypointrcnn_loss(
            lg, *[jnp.asarray(t) for t in (kboxes, kps, kmatched, kpos)])),
        (klogits,))

    # SSD with the minibatch idf: GTs 4, 1, 3, 2
    rng = np.random.RandomState(8)
    anchors_ssd = A.ssd_default_boxes((96, 96), ((12, 12), (6, 6), (3, 3)))
    na, m = anchors_ssd.shape[0], 4
    xy = rng.rand(4, m, 2) * 56
    sboxes = np.concatenate([xy, xy + 12 + rng.rand(4, m, 2) * 28], -1).astype(np.float32)
    slabels = rng.randint(1, 5, (4, m))
    svalid = np.arange(m)[None] < np.array([4, 1, 3, 2])[:, None]
    scls = (rng.randn(4, na, 5) * 2).astype(np.float32)
    sreg = (rng.randn(4, na, 4) * 0.5).astype(np.float32)
    ssd_cfg = JSSD.SSDConfig(num_classes=5, tfidf_mini_batch=True, tfidf_norm=2)
    cases["ssd tfidf_mini_batch"] = ({"fn": "ssd_loss", "args": [
        ("batch", scls), ("batch", sreg), ("shared", anchors_ssd), ("batch", sboxes),
        ("batch", slabels), ("batch", svalid), ("shared", port_config(SSD.SSDConfig, ssd_cfg))],
        "grad": [0, 1]},
        lambda cl, rg: (lambda out: (dict(out), sum(out.values())))(JSSD.ssd_loss(
            cl, rg, *[jnp.asarray(t) for t in (anchors_ssd, sboxes, slabels, svalid)],
            ssd_cfg)), (scls, sreg))

    # RetinaNet (a mean over images) with the minibatch idf
    rng = np.random.RandomState(9)
    xy = rng.rand(400, 2) * 56
    ranchors = np.concatenate([xy, xy + 4 + rng.rand(400, 2) * 24], -1).astype(np.float32)
    gxy = rng.rand(4, m, 2) * 40
    rboxes = np.concatenate([gxy, gxy + 6 + rng.rand(4, m, 2) * 20], -1).astype(np.float32)
    rboxes[:, :2] = ranchors[rng.randint(0, 400, (4, 2))]
    rlab = rng.randint(0, 5, (4, m))
    rcls = (rng.randn(4, 400, 5) * 2).astype(np.float32)
    rreg = (rng.randn(4, 400, 4) * 0.3).astype(np.float32)
    rn_cfg = JRN.RetinaNetConfig(num_classes=5, tfidf_mini_batch=True)
    cases["retinanet tfidf_mini_batch"] = ({"fn": "retinanet_loss", "args": [
        ("batch", rcls), ("batch", rreg), ("shared", ranchors), ("batch", rboxes),
        ("batch", rlab), ("batch", svalid), ("shared", port_config(RN.RetinaNetConfig, rn_cfg))],
        "grad": [0, 1]},
        lambda cl, rg: (lambda out: (dict(out), sum(out.values())))(JRN.retinanet_loss(
            cl, rg, *[jnp.asarray(t) for t in (ranchors, rboxes, rlab, svalid)], rn_cfg)),
        (rcls, rreg))

    cases["minibatch_idf"] = ({"fn": "minibatch_idf", "args": [
        ("batch", slabels), ("batch", svalid), ("shared", 6)], "grad": []},
        lambda: (lambda v: ({"0": v}, None))(jidf.minibatch_idf(jnp.asarray(slabels),
                                                           jnp.asarray(svalid), 6)), ())
    return cases


def ops_job():
    """(the ``ops`` job's input, what the parent keeps for its references)."""
    bn = bn_inputs()
    cases = loss_cases()
    return {"batch_norm": bn, "losses": {k: v[0] for k, v in cases.items()}}, (bn, cases)


@pytest.fixture(scope="module")
def ops(started):
    """The ``ops`` job's outputs of both ranks, and the JAX references."""
    directory, procs, (bn, cases) = started["ops"]
    try:
        ref_bn = {str(dt): flax_bn(bn, jdt) for dt, jdt in ((torch.float32, jnp.float32),
                                                             (torch.bfloat16, jnp.bfloat16))}
        ref_losses = {}
        for name, (_, fn, diff) in cases.items():
            args = [jnp.asarray(a) for a in diff]
            values = fn(*args)[0]
            grads = jax.grad(lambda *a, fn=fn: fn(*a)[1], argnums=tuple(range(len(args))))(
                *args) if args else ()
            ref_losses[name] = ({k: np.asarray(v) for k, v in values.items()},
                                [np.asarray(g) for g in grads])
    finally:
        outs = finish("ops", directory, procs)
    return outs, ref_bn, ref_losses


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_batch_norm_over_two_ranks_is_flax_s_on_the_whole_batch(ops, dtype):
    outs, ref_bn, _ = ops
    y, dx, dscale, dbias, mean, var = ref_bn[dtype]
    ranks = [o["batch_norm"][dtype] for o in outs]
    assert all(r["y_dtype"] == dtype for r in ranks)
    if dtype == "torch.float32":
        rtol, atol = 1e-5, 1e-5
    else:  # two bf16 ulps of the largest value
        rtol, atol = 0, 2 * 2.0 ** -8 * float(np.abs(y).max())
    np.testing.assert_allclose(whole([r["y"].numpy() for r in ranks]), y, rtol=rtol, atol=atol)
    dx_atol = 1e-5 if dtype == "torch.float32" else 2 * 2.0 ** -8 * float(np.abs(dx).max())
    np.testing.assert_allclose(whole([r["dx"].numpy() for r in ranks]), dx, rtol=1e-4,
                               atol=dx_atol)
    # the parameters' gradients: the ranks' sums, which DDP averages
    for key, ref in (("dweight", dscale), ("dbias", dbias)):
        np.testing.assert_allclose(sum(r[key].numpy() for r in ranks), ref, rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    # the running statistics: every rank's moved by the global batch's
    for r in ranks:
        np.testing.assert_allclose(r["running_mean"].numpy(), mean, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["running_var"].numpy(), var, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["yolo ce weighted", "yolo bce tfidf_batch", "yolo ce mean",
                                  "rpn", "fastrcnn ce", "fastrcnn bce", "mask", "keypoint",
                                  "ssd tfidf_mini_batch", "retinanet tfidf_mini_batch",
                                  "minibatch_idf"])
def test_loss_normalizer_over_two_ranks_is_jax_s_on_the_whole_batch(ops, name):
    """The mean of the ranks' values is JAX's loss (what DDP's mean of
    gradients and all_reduce_mean of the logged values see), and each
    rank's gradient over 2 is JAX's at its rows."""
    outs, _, ref_losses = ops
    ref_values, ref_grads = ref_losses[name]
    got = [o["losses"][name] for o in outs]
    assert sorted(ref_values) == sorted(got[0]["values"])
    for key, ref in ref_values.items():
        mean = np.mean([g["values"][key].numpy() for g in got], 0)
        np.testing.assert_allclose(mean, ref, rtol=1e-4, atol=1e-6, err_msg=key)
    for j, ref in enumerate(ref_grads):
        grad = whole([g["grads"][j].numpy() / WORLD for g in got])
        np.testing.assert_allclose(grad, ref, rtol=1e-4, atol=1e-7, err_msg=f"gradient {j}")
    if name != "minibatch_idf" and name != "retinanet tfidf_mini_batch":
        # a per-rank normalizer would differ: the ranks' own quotients disagree
        first = [next(iter(g["values"].values())).numpy() for g in got]
        assert not np.allclose(first[0], first[1], rtol=1e-3)


# -- the YOLO train step -------------------------------------------------------------

def yolo_batch(rng, counts):
    """Two 64 px images with 6 GT slots, ``counts`` of them valid."""
    valid = np.zeros((2, 6), bool)
    for i, n in enumerate(counts):
        valid[i, :n] = True
    return {"images": rng.rand(2, IMG, IMG, 3),
            "gt_boxes": np.concatenate([rng.rand(2, 6, 2) * 0.6 + 0.2,
                                        rng.rand(2, 6, 2) * 0.4 + 0.05], -1).astype(np.float32),
            "gt_labels": rng.randint(0, NUM_CLASSES, (2, 6)), "gt_valid": valid}


YOLO_CFG = JYC.YoloLossConfig(num_classes=NUM_CLASSES, img_size=IMG)


def yolo_job():
    """One float32 step and two float64 steps of the tiny YOLO (SGD 1e-3,
    momentum 0.9, weight decay 5e-4, a two-step warmup from half the rate)
    from the same weights in both frameworks; the first batch's images hold
    3 and 1 valid GTs, the second's 4 and 2. Returns (the ``yolo`` job's
    input, what the parent keeps for JAX's steps)."""
    cfg = YOLO_CFG
    opt = O.OptimizerConfig("sgd", 1e-3, 5e-4, 0.9)
    sch = O.SchedulerConfig("multistep", milestones=(10,), warmup_steps=2, warmup_factor=0.5)
    rng = np.random.RandomState(8)
    batches = [yolo_batch(rng, (3, 1)), yolo_batch(rng, (4, 2))]
    jax_runs, runs = {}, {}
    for name, steps, jdt, tdt in (("float32", 1, jnp.float32, torch.float32),
                                  ("float64", 2, jnp.float64, torch.float64)):
        with jax.enable_x64(jdt == jnp.float64):
            flax_model = FlaxYoloHead(num_classes=NUM_CLASSES, backbone_layers=(1, 1, 1, 1, 1),
                                      dtype=jdt)
            v = jax.jit(lambda k, m=flax_model, d=jdt: m.init(k, jnp.zeros((1, IMG, IMG, 3), d),
                                                              train=False))(jax.random.key(0))
            v = randomize_bn(v, 7)
        runs[name] = {"dtype": tdt, "batches": batches[:steps],
                      "state_dict": flax_yolo_to_torch(v["params"], v["batch_stats"])}
        jax_runs[name] = (flax_model, v, steps, jdt)
    return ({"runs": runs, "optimizer": opt, "scheduler": sch,
             "loss_cfg": port_config(YC.YoloLossConfig, cfg)}, (jax_runs, runs, batches, opt, sch))


@pytest.fixture(scope="module")
def yolo(started):
    """The ``yolo`` job's outputs of both ranks, JAX's steps on the whole
    batch, and the job's input."""
    directory, procs, (jax_runs, runs, batches, opt, sch) = started["yolo"]
    cfg = YOLO_CFG
    try:
        tx = JO.make_optimizer(JO.OptimizerConfig(**dataclasses.asdict(opt)),
                               JO.SchedulerConfig(**dataclasses.asdict(sch)))
        ref = {}
        for name, (flax_model, v, steps, jdt) in jax_runs.items():
            with jax.enable_x64(jdt == jnp.float64):
                jstate = JT.TrainState.create(
                    flax_model.apply,
                    jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), v["params"]),
                    jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), v["batch_stats"]), tx)
                metrics = []
                for b in batches[:steps]:
                    jstate, jm = JT.yolo_train_step(
                        jstate, jnp.asarray(b["images"], jdt), jnp.asarray(b["gt_boxes"]),
                        jnp.asarray(b["gt_labels"]), jnp.asarray(b["gt_valid"]), cfg,
                        NUM_CLASSES)
                    metrics.append(jax.tree_util.tree_map(np.asarray, jm))
                moved = flax_yolo_to_torch(*(jax.tree_util.tree_map(
                    lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64), new, old)
                    for new, old in ((jstate.params, v["params"]),
                                     (jstate.batch_stats, v["batch_stats"]))))
                ref[name] = (metrics, moved)
    finally:
        outs = finish("yolo", directory, procs)
    return outs, ref, runs


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_yolo_steps_over_two_ranks_match_jax_s_metrics(yolo, name):
    outs, ref, _ = yolo
    rtol = {"loss": 1e-4, "sub_losses": 1e-4, "stats": 1e-4,
            "grad_norm": 1e-3 if name == "float32" else 1e-4}
    for step, jm in enumerate(ref[name][0]):
        for r, out in enumerate(outs):
            m = out[name]["metrics"][step]
            for key, tol in rtol.items():
                np.testing.assert_allclose(m[key].double().numpy(), jm[key], rtol=tol, atol=1e-6,
                                           err_msg=f"rank {r}, step {step}, {key}")
        # each rank's own share is not the global loss: the GT counts differ
        shares = [out[name]["metrics"][step]["rank_loss"].item() for out in outs]
        assert abs(shares[0] - shares[1]) > 1e-3 * abs(float(jm["loss"]))


def test_two_float64_yolo_steps_over_two_ranks_move_every_tensor_as_jax(yolo):
    """Each parameter's and running statistic's update by the two steps
    within UPDATE_SHARE of that tensor's largest, on both ranks alike."""
    outs, ref, runs = yolo
    initial = runs["float64"]["state_dict"]
    moved = ref["float64"][1]
    compared = 0
    for key, upd_ref in moved.items():
        if key.endswith("num_batches_tracked"):
            continue
        largest = upd_ref.double().abs().max().item()
        assert largest > 0, key
        for out in outs:
            upd = out["float64"]["state_dict"][key].double() - initial[key].double()
            np.testing.assert_allclose(upd.numpy(), upd_ref.double().numpy(), rtol=0,
                                       atol=UPDATE_SHARE * largest, err_msg=key)
        compared += 1
    assert compared == sum(1 for k in initial if not k.endswith("num_batches_tracked"))
    assert all(torch.equal(outs[0]["float64"]["state_dict"][k], outs[1]["float64"]["state_dict"][k])
               for k in initial)


# -- detection_main ------------------------------------------------------------------

DETECTION = {name: 300 if name.startswith("ssd") else 64 for name in DM.MODELS}


def detection_batch(name: str, size: int) -> dict:
    """Four images: two seeded ``adapter_batch`` pairs (3 and 2 valid GTs
    each), so the ranks hold 6 and 4."""
    from object_detectors_tpu_torch.train.tiny_steps import adapter_batch

    pairs = [adapter_batch(name, size, seed) for seed in (4, 5)]
    return {k: np.concatenate([p[k].numpy() for p in pairs]) for k in pairs[0]}


def detection_job():
    batches = {name: {"size": size, "batch": detection_batch(name, size)}
               for name, size in DETECTION.items()}
    return {"steps": batches, "seed": 3, "eval_batch_size": 2}, batches


@pytest.fixture(scope="module")
def detection(started):
    """Each architecture's step at world size 2 and 1, and the sharded and
    the one-process evaluation."""
    directory, procs, batches = started["detection"]
    try:
        one = {name: W.detection_step(name, c["size"], c["batch"], 3)
               for name, c in batches.items()}
        one_eval = W.sharded_eval(2)
    finally:
        outs = finish("detection", directory, procs)
    return outs, one, one_eval


@pytest.mark.parametrize("name", DM.MODELS)
def test_detection_step_over_two_ranks_is_the_one_process_step(detection, name):
    outs, one, _ = detection
    ref = one[name]
    for out in outs:
        got = out["steps"][name]
        for k, v in ref["losses"].items():
            np.testing.assert_allclose(got["losses"][k].item(), v.item(), rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got["total"].item(), ref["total"].item(), rtol=1e-4)
    floor = CANCEL_SHARE * max(g.abs().max().item() for g in ref["grads"].values())
    for key, grad in ref["grads"].items():
        atol = DETECTION_GRAD_SHARE * grad.abs().max().item() + floor
        for out in outs:
            np.testing.assert_allclose(out["steps"][name]["grads"][key].numpy(), grad.numpy(),
                                       rtol=0, atol=atol, err_msg=key)
    assert len(ref["grads"]) == len(outs[0]["steps"][name]["grads"])
    # DDP keeps the replicas equal
    for key in ref["state_dict"]:
        assert torch.equal(outs[0]["steps"][name]["state_dict"][key],
                           outs[1]["steps"][name]["state_dict"][key]), key


def test_sharded_evaluation_scores_each_image_once(detection):
    """7 images over two ranks: rank 1's last batch repeats image 0, which
    the merge drops; the results and the mAP are those of one process."""
    outs, _, one_eval = detection

    def by_image(results):
        out = {}
        for r in results:
            out.setdefault(r["image_id"], []).append(r)
        return {k: sorted(v, key=lambda r: -r["score"]) for k, v in out.items()}

    ref = by_image(one_eval["results"])
    assert len(ref) == 7
    for out in outs:
        got = by_image(out["eval"]["results"])
        assert sorted(got) == sorted(ref)
        for image, results in ref.items():
            assert [r["category_id"] for r in got[image]] == [r["category_id"] for r in results]
            for a, b in zip(got[image], results):
                assert abs(a["score"] - b["score"]) <= SCORE_ATOL, image
                np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=BOX_ATOL)
        assert out["eval"]["mAP"] == one_eval["mAP"]


# -- main.train_pipeline ---------------------------------------------------------------

YOLO_CLI = ["dataset=synthetic", "backbone=tiny", "dataset.num_images=8",
            "dataset.canvas_size=96", "precision=f32", "metric=mAP", "device=cpu"]


def pipeline_job(directory: Path):
    """Two epochs straight, and one epoch then a resume to two, each in
    its own output directory under ``directory``."""
    runs = [("straight", [*YOLO_CLI, "epochs=2", f"output_dir={directory / 'straight'}"]),
            ("first", [*YOLO_CLI, "epochs=1", f"output_dir={directory / 'resumed'}"]),
            ("resume", [*YOLO_CLI, "epochs=2", "resume=true",
                        f"output_dir={directory / 'resumed'}"])]
    return {"runs": runs}, None


@pytest.fixture(scope="module")
def pipeline(started):
    directory, procs, _ = started["pipeline"]
    outs = finish("pipeline", directory, procs)
    last = {name: torch.load(directory / name / "checkpoints" / "last.pt", weights_only=True)
            for name in ("straight", "resumed")}
    rows = (directory / "resumed" / "progress" / "progress.csv").read_text().splitlines()
    for path in directory.rglob("*.pt"):
        path.unlink()
    return outs, last, rows


def test_train_pipeline_over_two_ranks_writes_checkpoints_on_rank_zero_only(pipeline):
    outs, _, _ = pipeline
    assert outs[1]["writes"] == []
    tags = [(d, tag, epoch) for d, tag, epoch in outs[0]["writes"]]
    # last every epoch, best when the mAP improves
    assert [t for t in tags if t[1] == "last"] == [("checkpoints", "last", e)
                                                  for e in (0, 1, 0, 1)]
    for out in outs:
        assert out["runs"]["straight"]["step"] == 4  # 8 images, 4 a global batch, 2 epochs
        assert out["runs"]["resume"]["step"] == 4
        assert out["runs"]["straight"]["best"] == outs[0]["runs"]["straight"]["best"]


def test_train_pipeline_over_two_ranks_resumes_bitwise(pipeline):
    _, last, rows = pipeline
    _payloads_equal(last["resumed"], last["straight"])
    assert last["straight"]["step"] == 4 and last["straight"]["optimizer"]["count"] == 4
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1"]  # the resume began at epoch 1
