"""The port's RoIAlign (object_detectors_tpu_torch/ops/roi_align.py and the
plain version of kernels/roi_align.py) against the JAX poolers: the XLA
roi_align and canvas pooler, and the Pallas hybrid pooler in its
bands_grouped and tiled modes, run in interpret mode; the backward
(kernels/roi_align_bwd.py's plain version, pool_multiscale under autograd)
against jax.grad of the canvas and flat poolers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu.kernels.roi_align_pallas import multiscale_roi_align_hybrid
from object_detectors_tpu.ops import roi_align as jax_ra
from object_detectors_tpu_torch.kernels import roi_align as K
from object_detectors_tpu_torch.kernels import roi_align_bwd as KB
from object_detectors_tpu_torch.ops import roi_align as R
from test_roi_align_pallas import _setup

SIZE = 256
EXTREME = [[0, 0, 256, 256], [250, 250, 256, 256], [0, 0, 256, 6], [3, 0, 9, 256]]


def nchw(feats):
    """JAX NHWC level maps -> NCHW tensors in channels_last memory."""
    return [torch.from_numpy(np.array(f)).permute(0, 3, 1, 2) for f in feats]


def test_assign_fpn_levels_matches_jax():
    rng = np.random.RandomState(0)
    xy = rng.rand(500, 2).astype(np.float32) * 600
    wh = np.exp(rng.rand(500, 2) * 7).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    # sides at the level boundaries, zero and negative areas
    boxes[:6] = [[0, 0, 112, 112], [0, 0, 224, 224], [0, 0, 448, 448], [5, 5, 5, 9],
                 [9, 9, 5, 5], [0, 0, 111.99, 112]]
    for levels in (4, 2):
        out = R.assign_fpn_levels(torch.from_numpy(boxes), levels)
        ref = jax_ra.assign_fpn_levels(jnp.asarray(boxes), levels)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert set(out.tolist()) == {0, 1}


@pytest.mark.parametrize("output_size,scale,ratio", [((7, 7), 0.25, 2), ((14, 14), 0.125, 2),
                                                     ((7, 7), 0.5, 3)])
def test_roi_align_matches_jax(output_size, scale, ratio):
    feats, boxes = _setup(seed=1, b=1, n=30)
    f = np.array(feats[0][0])
    bx = boxes[0]
    bx[:4] = EXTREME
    out = R.roi_align(torch.from_numpy(f).permute(2, 0, 1), torch.from_numpy(bx),
                      output_size, scale, ratio)
    ref = jax_ra.roi_align(jnp.asarray(f), jnp.asarray(bx), output_size, scale, ratio)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("output_size", [(7, 7), (14, 14)])
def test_canvas_pooler_matches_jax(output_size):
    feats, boxes = _setup(seed=3)
    boxes[0, :4] = EXTREME
    for i in range(boxes.shape[0]):
        out = R.multiscale_roi_align_canvas([f[i] for f in nchw(feats)],
                                            torch.from_numpy(boxes[i]), (SIZE, SIZE),
                                            output_size)
        ref = jax_ra.multiscale_roi_align_canvas(tuple(f[i] for f in feats),
                                                 jnp.asarray(boxes[i]), (SIZE, SIZE),
                                                 output_size)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


# bands_grouped takes about 30 s to interpret per new shape here, so it runs
# at the one shape of the mixed and extreme cases; tiled runs every case
@pytest.mark.parametrize("mode,case", [
    ("bands_grouped", "mixed"), ("bands_grouped", "extreme"), ("tiled", "mixed"),
    ("tiled", "extreme"), ("tiled", "single"), ("tiled", "14x14")])
def test_pool_multiscale_matches_pallas_pooler(mode, case):
    output_size = (14, 14) if case == "14x14" else (7, 7)
    feats, boxes = _setup(seed=7, n=12 if case == "14x14" else 40)
    if case == "extreme":
        boxes[0, :4] = EXTREME
        boxes[1, :2] = [[5, 5, 40, 200], [10, 10, 200, 40]]
    elif case == "single":
        boxes = np.asarray([[[10.0, 12.0, 60.0, 70.0]]] * 2, np.float32)
    else:
        boxes[..., 2] = np.minimum(boxes[..., 2], boxes[..., 0] + 100)
        boxes[..., 3] = np.minimum(boxes[..., 3], boxes[..., 1] + 100)
    ref = multiscale_roi_align_hybrid(feats, jnp.asarray(boxes), (SIZE, SIZE), output_size,
                                      interpret=True, mode=mode)
    out = R.pool_multiscale(nchw(feats), torch.from_numpy(boxes), (SIZE, SIZE), output_size)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_reference_keeps_the_feature_dtype_and_layout():
    feats, boxes = _setup(seed=2, n=5)
    maps = [f.to(torch.bfloat16) for f in nchw(feats)]
    out = K.multiscale_roi_align_reference(maps, torch.from_numpy(boxes), (SIZE, SIZE))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 5, 7, 7, 8)
    f32 = K.multiscale_roi_align_reference([m.float() for m in maps], torch.from_numpy(boxes),
                                           (SIZE, SIZE))
    torch.testing.assert_close(out, f32.to(torch.bfloat16), rtol=0, atol=0)
    empty = K.multiscale_roi_align_reference(maps, torch.zeros(0, 5, 4), (SIZE, SIZE))
    assert empty.shape == (0, 5, 7, 7, 8)


def test_infer_scale_and_its_check():
    assert R._infer_scale((160, 160), (640, 640)) == jax_ra._infer_scale((160, 160), (640, 640))
    assert R._infer_scale((13, 13), (800, 800)) == 1 / 64
    with pytest.raises(ValueError, match="anisotropic"):
        R._infer_scale((160, 80), (640, 640))


def test_cuda_wrapper_checks_its_inputs():
    feats, boxes = _setup(seed=2, n=5)
    maps = nchw(feats)
    with pytest.raises(ValueError, match="CUDA"):
        K.multiscale_roi_align_cuda(maps, torch.from_numpy(boxes), (SIZE, SIZE))
    with pytest.raises(ValueError, match="level maps"):
        K.multiscale_roi_align_cuda(maps * 2, torch.from_numpy(boxes), (SIZE, SIZE))
    with pytest.raises(ValueError, match="boxes"):
        K.multiscale_roi_align_cuda(maps, torch.from_numpy(boxes).double(), (SIZE, SIZE))


def test_one_pixel_level_follows_the_flat_pooler():
    """At a 32 px image P5 is 1x1. There the JAX canvas pooler's 2x2 slice
    starts one row above the level and is clipped into the next rows of its
    canvas, so it differs from the JAX flat pooler (torchvision semantics);
    the port follows the flat pooler."""
    rng = np.random.RandomState(0)
    feats = [rng.randn(32 // s, 32 // s, 4).astype(np.float32) for s in (4, 8, 16, 32)]
    boxes = np.asarray([[0, 0, 500, 500], [-10, -10, 470, 460]], np.float32)
    assert np.asarray(jax_ra.assign_fpn_levels(jnp.asarray(boxes), 4)).tolist() == [3, 3]
    out = R.multiscale_roi_align_canvas([torch.from_numpy(f).permute(2, 0, 1) for f in feats],
                                        torch.from_numpy(boxes), (32, 32))
    flat = jax_ra.multiscale_roi_align_flat(tuple(map(jnp.asarray, feats)), jnp.asarray(boxes),
                                            (32, 32))
    canvas = jax_ra.multiscale_roi_align_canvas(tuple(map(jnp.asarray, feats)),
                                                jnp.asarray(boxes), (32, 32))
    np.testing.assert_allclose(out.numpy(), np.asarray(flat), rtol=1e-4, atol=1e-5)
    assert np.abs(np.asarray(canvas) - np.asarray(flat)).max() > 0.1


@pytest.mark.parametrize("levels,output_size", [(1, (7, 7)), (1, (14, 14)), (4, (7, 7)),
                                                (4, (14, 14))])
def test_staging_window_holds_every_corner_the_plain_pooler_reads(levels, output_size):
    """The rule by which the RoIAlign kernel stages a RoI's footprint
    (kernels/roi_align.py:staging_window) against the sample positions of
    the plain pooler (ops/roi_align.py:roi_samples, which _pool_flat reads):
    the listed rows and columns are exactly the corners of the samples
    inside the map, ascending; on P2 alone some footprints are over the
    stage and one is exactly at it."""
    feats, boxes = _setup(seed=4, n=30)
    boxes[0, :len(EXTREME) + 8] = EXTREME + [[10, 10, 76, 34], [10, 10, 76, 72],
                                             [10, 10, 130, 130], [10, 10, 90, 166],
                                             [-50, -40, 30, 20], [0, 0, 112, 112],
                                             [0, 0, 224, 224], [40, 40, 30, 30]]
    maps = nchw(feats)[:levels]
    rows, cols = K.staging_window(maps, torch.from_numpy(boxes), (SIZE, SIZE), output_size)
    oh, ow = output_size
    assert rows.shape == (*boxes.shape[:2], 2 * oh * 2) and cols.shape[-1] == 2 * ow * 2
    flat = torch.from_numpy(boxes).reshape(-1, 4)
    sizes = [m.shape[-2:] for m in maps]
    lv = R.assign_fpn_levels(flat, levels).long()
    scale = torch.tensor([R._infer_scale(hw, (SIZE, SIZE)) for hw in sizes])[lv]
    hw = torch.tensor([[float(h), float(w)] for h, w in sizes])[lv]
    (oy, y0, y1, _), (ox, x0, x1, _) = R.roi_samples(flat, scale, hw[:, 0], hw[:, 1],
                                                     output_size, 2)
    foot = []
    for i in range(flat.shape[0]):
        for listed, outside, i0, i1 in ((rows.view(-1, rows.shape[-1])[i], oy[i], y0[i], y1[i]),
                                        (cols.view(-1, cols.shape[-1])[i], ox[i], x0[i], x1[i])):
            n = int((listed >= 0).sum())
            corners = set(i0[~outside].long().tolist()) | set(i1[~outside].long().tolist())
            assert listed[:n].tolist() == sorted(corners) and (listed[n:] == -1).all()
        foot.append(int((rows.view(-1, rows.shape[-1])[i] >= 0).sum())
                    * int((cols.view(-1, cols.shape[-1])[i] >= 0).sum()))
    assert max(foot) <= (2 * oh * 2) * (2 * ow * 2)
    if levels == 1:
        assert max(foot) > K.STAGE_PIXELS  # these read their corners directly
        if output_size == (7, 7):
            assert K.STAGE_PIXELS in foot  # [10, 10, 76, 72]: 16 x 17 on P2
            assert K.STAGE_PIXELS // 2 in foot  # [10, 10, 76, 34]: 8 x 17, two slice buffers


@pytest.mark.parametrize("dtype,c,offset,vectors", [
    (torch.bfloat16, 256, 0, True), (torch.bfloat16, 8, 0, True), (torch.bfloat16, 12, 0, False),
    (torch.bfloat16, 256, 8, True), (torch.bfloat16, 256, 4, False), (torch.float32, 4, 0, True),
    (torch.float32, 3, 0, False), (torch.float32, 256, 1, False)])
def test_staged_rois_needs_16_byte_channel_runs_on_aligned_maps(dtype, c, offset, vectors):
    """The kernel's branch as kernels/roi_align.py:staged_rois states it: the
    footprint rule (staging_window's rows x columns <= STAGE_PIXELS) where
    the channels are whole 16-byte runs and every level map starts on a
    16-byte boundary (here P3 starts ``offset`` elements into its buffer),
    no RoI staged otherwise."""
    boxes = torch.tensor([[[10, 10, 76, 72], [10, 10, 76, 34], [0, 0, 250, 250],
                           [10, 10, 90, 166], [30, 40, 50, 60], [100, 20, 180, 90]]])
    maps = []
    for stride, skip in ((4, 0), (8, offset)):
        h = SIZE // stride
        buf = torch.zeros(skip + h * h * c, dtype=dtype)
        assert buf.data_ptr() % 16 == 0
        maps.append(buf[skip:].view(1, h, h, c).permute(0, 3, 1, 2))
    staged, foot = K.staged_rois(maps, boxes, (SIZE, SIZE))
    rows, cols = K.staging_window(maps, boxes, (SIZE, SIZE))
    assert torch.equal(foot, (rows >= 0).sum(-1) * (cols >= 0).sum(-1))
    assert foot[0, :2].tolist() == [K.STAGE_PIXELS, K.STAGE_PIXELS // 2]
    assert torch.equal(staged, (foot <= K.STAGE_PIXELS) & vectors)
    assert bool(staged.any()) == vectors and not bool(staged.all())


@pytest.mark.parametrize("c", [256, 8, 6])
@pytest.mark.parametrize("output_size,foot,direct", [
    ((7, 7), [4, 784, 0, 9, 784, 100], [1, 4]), ((14, 14), [4, 841, 0, 9, 3136, 289], [4])])
def test_backward_routes_on_hand_built_boxes(c, output_size, foot, direct):
    """The backward kernel's rule (kernels/roi_align.py:backward_routes) on
    one 64 x 64 level of a 256² image: a box under a pixel there (2 x 2
    pixels, and 3 x 3 across a pixel edge), bins of 4 pixels (28 x 28 at
    7x7, the most at s = 2; 56 x 56 at 14x14), a box wholly outside (no
    pixel) and one half outside. A RoI is staged unless its footprint
    reaches half its samples' corners (4 s^2 oh ow: 784 at 7x7, 3136 at
    14x14). Reductions, each of 4 channels where they come in runs of 4 and
    of 1 otherwise, in each block of up to 64 channels: staged, one a
    footprint pixel and vector; direct, one a vector and corner of every
    sample, all inside here."""
    boxes = torch.tensor([[[0.0, 0, 4, 4], [0, 0, 112, 112], [-200, -200, -150, -150],
                           [10, 10, 11, 11], [0, 0, 224, 224], [-128, -128, 64, 64]]])
    shapes = [(1, c, 64, 64)]
    staged, pixels = K.backward_routes(shapes, boxes, (SIZE, SIZE), output_size)
    assert pixels[0].tolist() == foot
    assert torch.nonzero(~staged[0]).flatten().tolist() == direct
    assert int(staged.sum()) == len(foot) - len(direct)
    vectors = min(c, 64) // 4 if c % 4 == 0 else min(c, 64)  # in each block of channels
    samples = 4 * 2 * 2 * output_size[0] * output_size[1]
    want = sum(samples if i in direct else f for i, f in enumerate(foot)) * vectors * -(-c // 64)
    assert K.backward_reductions(shapes, boxes, (SIZE, SIZE), output_size) == want


@pytest.mark.parametrize("c,out,s,want", [
    (256, (7, 7), 2, 64), (20, (7, 7), 2, 20), (6, (7, 7), 2, 6), (256, (14, 14), 4, 64),
    (256, (7, 7), 16, 64), (256, (7, 7), 32, 20), (256, (17, 17), 2, 56), (3, (7, 7), 80, 0)])
def test_backward_slice(c, out, s, want):
    """The backward kernel's channel slice (kernels/roi_align.py:backward_slice):
    64 channels, all of them where there are fewer, narrowed where 4 s^2 oh
    ow items a channel would reach 2^22 (7x7 at s = 32: 20) or oh ow f32 a
    channel exceed 64 KiB (17x17: 56); where not even 4 channels fit the
    wrapper raises a ValueError naming the limit instead of launching."""
    assert K.backward_slice(c, out, s) == want
    if want == 0:
        boxes = torch.zeros(1, 1, 4)
        with pytest.raises(ValueError, match="2\\^22"):
            KB.multiscale_roi_align_backward_cuda(torch.zeros(1, 1, *out, c), boxes,
                                                  [(1, c, 8, 8)], (SIZE, SIZE), out, s)


# -- the backward: kernels/roi_align_bwd.py's plain version and the autograd
# of ops/roi_align.py:pool_multiscale, against jax.grad of the JAX poolers.
# The same products in other summation orders: rtol 1e-4, atol 1e-5.

def _jax_pool_grad(pool, feats, boxes, cot, size):
    """jax.grad of the batched JAX pooler ``pool`` for the cotangent ``cot``
    -> NCHW numpy maps."""
    def f(fs):
        out = jax.vmap(lambda f_, b_: pool(f_, b_, (size, size), (7, 7)))(fs, jnp.asarray(boxes))
        return jnp.sum(out * jnp.asarray(cot))
    return [np.asarray(g).transpose(0, 3, 1, 2) for g in jax.grad(f)(tuple(feats))]


@pytest.mark.parametrize("seed", [4, 5])
def test_backward_matches_jax_grad_of_the_canvas_pooler(seed):
    feats, boxes = _setup(seed=seed, n=30)  # P2-P5 of 256 px: at least 8 px a level
    boxes[0, :4] = EXTREME
    boxes[1, :2] = [[-200, -200, 300, 300], [-300, -250, 256, 256]]  # P5's
    cot = np.random.RandomState(seed).randn(*boxes.shape[:2], 7, 7, 8).astype(np.float32)
    ref = _jax_pool_grad(jax_ra.multiscale_roi_align_canvas, feats, boxes, cot, SIZE)
    shapes = [tuple(m.shape) for m in nchw(feats)]
    out = KB.multiscale_roi_align_backward_reference(
        torch.from_numpy(cot), torch.from_numpy(boxes), shapes, (SIZE, SIZE))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and o.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-5)
    assert all(np.abs(r).max() > 0 for r in ref)  # every level took RoIs


def test_backward_on_one_pixel_levels_matches_jax_grad_of_the_flat_pooler():
    """At a 32 px image P5 is 1x1, where the JAX canvas pooler reads the next
    rows of its canvas (test_one_pixel_level_follows_the_flat_pooler); the
    backward follows the flat pooler there too."""
    rng = np.random.RandomState(1)
    feats = [jnp.asarray(rng.randn(2, 32 // s, 32 // s, 4).astype(np.float32))
             for s in (4, 8, 16, 32)]
    boxes = np.asarray([[[0, 0, 500, 500], [-10, -10, 470, 460], [2, 3, 20, 30]]] * 2,
                       np.float32)
    cot = rng.randn(2, 3, 7, 7, 4).astype(np.float32)
    ref = _jax_pool_grad(jax_ra.multiscale_roi_align_flat, feats, boxes, cot, 32)
    canvas = _jax_pool_grad(jax_ra.multiscale_roi_align_canvas, feats, boxes, cot, 32)
    out = KB.multiscale_roi_align_backward_reference(
        torch.from_numpy(cot), torch.from_numpy(boxes), [tuple(m.shape) for m in nchw(feats)],
        (32, 32))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-5)
    assert max(np.abs(c - r).max() for c, r in zip(canvas, ref)) > 0.1


def test_pool_multiscale_autograd_is_the_plain_backward():
    """On the CPU ``pool_multiscale`` under autograd runs the plain pooler
    forward and its autograd backward, f32 accumulation rounded to the maps'
    dtype; the boxes get no gradient."""
    feats, boxes = _setup(seed=6, n=12)
    cot = torch.from_numpy(np.random.RandomState(6).randn(2, 12, 7, 7, 8).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        maps = [m.to(dtype).requires_grad_() for m in nchw(feats)]
        tb = torch.from_numpy(boxes).requires_grad_()
        out = R.pool_multiscale(maps, tb, (SIZE, SIZE))
        assert out.dtype == dtype and out.requires_grad
        torch.testing.assert_close(out, K.multiscale_roi_align_reference(
            [m.detach() for m in maps], tb.detach(), (SIZE, SIZE)), rtol=0, atol=0)
        (out.float() * cot).sum().backward()
        ref = KB.multiscale_roi_align_backward_reference(
            cot.to(dtype), tb.detach(), [tuple(m.shape) for m in maps], (SIZE, SIZE),
            dtype=dtype)
        for m, r in zip(maps, ref):
            assert m.grad.dtype == dtype
            torch.testing.assert_close(m.grad, r, rtol=0, atol=0)
        assert tb.grad is None
    with torch.no_grad():  # no gradient to record
        assert not R.pool_multiscale(maps, tb, (SIZE, SIZE)).requires_grad


def test_backward_cuda_wrapper_checks_its_inputs():
    feats, boxes = _setup(seed=2, n=5)
    shapes = [tuple(m.shape) for m in nchw(feats)]
    cot = torch.zeros(2, 5, 7, 7, 8)
    with pytest.raises(ValueError, match="CUDA"):
        KB.multiscale_roi_align_backward_cuda(cot, torch.from_numpy(boxes), shapes, (SIZE, SIZE))
    with pytest.raises(ValueError, match="cotangent"):
        KB.multiscale_roi_align_backward_cuda(cot[:, :4], torch.from_numpy(boxes), shapes,
                                              (SIZE, SIZE))
    with pytest.raises(ValueError, match="level maps"):
        KB.multiscale_roi_align_backward_cuda(cot, torch.from_numpy(boxes), shapes * 2,
                                              (SIZE, SIZE))
    with pytest.raises(TypeError):
        KB.multiscale_roi_align_backward_cuda(cot.half(), torch.from_numpy(boxes), shapes,
                                              (SIZE, SIZE))
