"""The port's legacy per-scale YOLO loss and decoder
(``object_detectors_tpu_torch/models/yolo_legacy.py``) against the JAX
package's, on the CPU, with the cases of ``tests/test_yolo_legacy.py``.

Tolerances: the target grids bitwise, except ``tw`` / ``th`` within one
f32 ulp (XLA's log and PyTorch's differ by one at some inputs); the decode
within 1e-5; the loss and its gradient with respect to ``raw`` within 1e-5
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.models import yolo_legacy as JY
from object_detectors_tpu_torch.models import yolo_legacy as TY

ANCHORS = ((16, 16), (32, 24), (48, 48))
JCFG = JY.YoloLegacyConfig(num_classes=4, img_size=64, anchors=ANCHORS)
CFG = TY.YoloLegacyConfig(num_classes=4, img_size=64, anchors=ANCHORS)
TARGETS = ("mask", "noobj", "tx", "ty", "tw", "th", "tcls")


def targets_both(gt, gv, gl, hw=(4, 4)):
    """(JAX's targets stacked over the images, the port's) as numpy."""
    scaled = np.asarray(ANCHORS, np.float32) / (64 / hw[1])
    jax_t = [JY._targets_one(jnp.asarray(gt[i]), jnp.asarray(gv[i]), jnp.asarray(gl[i]), hw,
                             jnp.asarray(scaled), 4, 0.5) for i in range(len(gt))]
    jax_t = [np.stack([np.asarray(t[k]) for t in jax_t]) for k in range(7)]
    port = TY._targets_one(torch.from_numpy(gt), torch.from_numpy(gv),
                           torch.from_numpy(gl).long(), hw, torch.from_numpy(scaled), 4, 0.5)
    return jax_t, [t.numpy() for t in port]


def assert_targets_equal(jax_t, port):
    for name, j, t in zip(TARGETS, jax_t, port):
        assert j.shape == t.shape, name
        if name in ("tw", "th"):
            np.testing.assert_array_max_ulp(j, t, maxulp=1)
        else:
            np.testing.assert_array_equal(j, t, err_msg=name)


def test_targets_scatter_into_correct_cell():
    # one GT centred at (0.3, 0.6) on a 4x4 grid -> cell (gi=1, gj=2)
    gt = np.asarray([[[0.3, 0.6, 0.25, 0.25]]], np.float32)
    gv = np.ones((1, 1), bool)
    gl = np.asarray([[2]], np.int32)
    jax_t, port = targets_both(gt, gv, gl)
    assert_targets_equal(jax_t, port)
    mask, noobj, tx, _, _, _, tcls = port
    assert mask.sum() == 1
    _, j, i, a = np.argwhere(mask)[0]
    assert (j, i) == (2, 1)
    assert not noobj[0, j, i, a]
    assert tx[0, j, i, a] == pytest.approx(0.2, abs=1e-5)
    assert tcls[0, j, i, a, 2] == 1.0
    loss, _ = TY.yolo_legacy_loss(torch.zeros(1, 4, 4, 27), torch.from_numpy(gt),
                                  torch.from_numpy(gl).long(), torch.from_numpy(gv), CFG)
    assert np.isfinite(float(loss))


def test_padding_invariance():
    gt = np.asarray([[[0.3, 0.6, 0.25, 0.25], [0.5, 0.5, 0.2, 0.2]]], np.float32)
    gv = np.asarray([[True, False]])
    gl = np.asarray([[2, 1]], np.int32)
    raw = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 4, 27).astype(np.float32))
    l1, _ = TY.yolo_legacy_loss(raw, torch.from_numpy(gt), torch.from_numpy(gl).long(),
                                torch.from_numpy(gv), CFG)
    l2, _ = TY.yolo_legacy_loss(raw, torch.from_numpy(gt[:, :1]),
                                torch.from_numpy(gl[:, :1]).long(),
                                torch.from_numpy(gv[:, :1]), CFG)
    assert float(l1) == float(l2)
    jl, _ = JY.yolo_legacy_loss(jnp.asarray(raw.numpy()), jnp.asarray(gt), jnp.asarray(gl),
                                jnp.asarray(gv), JCFG)
    np.testing.assert_allclose(float(l1), float(jl), rtol=1e-5)


def test_legacy_decode_golden():
    out = TY.yolo_legacy_decode(torch.zeros(1, 4, 4, 27), CFG).numpy()
    assert out.shape == (1, 3 * 16, 9)
    np.testing.assert_allclose(out[0, 0, 0], 8.0, rtol=1e-5)   # (sig(0) + 0) * 16
    np.testing.assert_allclose(out[0, 0, 2], 16.0, rtol=1e-5)  # exp(0) * 1 * 16
    np.testing.assert_allclose(out[0, 0, 4], 0.5, rtol=1e-5)
    np.testing.assert_allclose(out[0, 16, 2], 32.0, rtol=1e-5)  # anchor 1, cell (0, 0)
    raw = np.random.RandomState(1).randn(2, 4, 4, 27).astype(np.float32)
    ref = np.asarray(JY.yolo_legacy_decode(jnp.asarray(raw), JCFG))
    got = TY.yolo_legacy_decode(torch.from_numpy(raw), CFG).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_loss_and_grad_match_jax():
    rng = np.random.RandomState(2)
    b, m = 3, 6
    gt = np.concatenate([rng.rand(b, m, 2), rng.rand(b, m, 2) * 0.6 + 0.05], -1).astype(
        np.float32)
    gv = rng.rand(b, m) < 0.7
    gl = rng.randint(0, 4, (b, m)).astype(np.int32)
    raw = rng.randn(b, 4, 4, 27).astype(np.float32)
    assert_targets_equal(*targets_both(gt, gv, gl))

    def jax_loss(r):
        return JY.yolo_legacy_loss(r, jnp.asarray(gt), jnp.asarray(gl), jnp.asarray(gv),
                                   JCFG)[0]

    jl, jg = jax.value_and_grad(jax_loss)(jnp.asarray(raw))
    jparts = JY.yolo_legacy_loss(jnp.asarray(raw), jnp.asarray(gt), jnp.asarray(gl),
                                 jnp.asarray(gv), JCFG)[1]
    r = torch.from_numpy(raw).requires_grad_()
    loss, parts = TY.yolo_legacy_loss(r, torch.from_numpy(gt), torch.from_numpy(gl).long(),
                                      torch.from_numpy(gv), CFG)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose([p.item() for p in parts], [float(p) for p in jparts],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-8)


def test_two_gts_on_one_cell_last_writer_wins():
    # two valid GTs with the same centre cell and the same best anchor, then
    # a padded row at the same place: JAX's scatter keeps the later GT's
    # offsets and sizes, the padded row writes nothing
    gt = np.asarray([[[0.30, 0.60, 0.25, 0.25], [0.36, 0.70, 0.26, 0.24],
                      [0.33, 0.65, 0.90, 0.90]]], np.float32)
    gv = np.asarray([[True, True, False]])
    gl = np.asarray([[2, 3, 1]], np.int32)
    jax_t, port = targets_both(gt, gv, gl)
    assert_targets_equal(jax_t, port)
    mask, _, tx, ty, tw, _, tcls = port
    assert mask.sum() == 1
    _, j, i, a = np.argwhere(mask)[0]
    assert tx[0, j, i, a] == pytest.approx(0.36 * 4 - 1, abs=1e-6)
    assert ty[0, j, i, a] == pytest.approx(0.70 * 4 - 2, abs=1e-6)
    assert tw[0, j, i, a] == pytest.approx(np.log(0.26 * 64 / 16), abs=1e-6)
    # the class grid takes both GTs' classes
    assert tcls[0, j, i, a].tolist() == [0.0, 0.0, 1.0, 1.0]
