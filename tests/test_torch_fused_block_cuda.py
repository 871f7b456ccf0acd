"""The fused bottleneck kernel (object_detectors_tpu_torch/csrc/fused_block.cu)
against its plain PyTorch version on the GPU, TF32 off, at the tolerance of
tests/test_fused_block.py (rtol 0.1, atol 0.15, |mean difference| < 1e-2),
and at the agreement left when both take the same folded operands and round
at the same points: the largest difference within one bf16 ulp of
max(|plain|, 1) over the output, under a tenth of the elements not bitwise
equal, and none at the small shapes (Cin <= 32, Cm 8), whose sums are short.
Both variants of the kernel source are held so: v4 (TMA + wgmma) at channel
counts that are multiples of 64 with Cm <= 512, at each of its tiles, their
edges and with a projection; v2 (mma.sync) at the others. A block prepared
once follows its module's weights when they change on the card.
Imports no JAX, so that it runs on a machine with a card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_block_cuda.py
"""

import math

import pytest
import torch

from object_detectors_tpu_torch.kernels import fused_block as K
from object_detectors_tpu_torch.models.resnet import Bottleneck


def _block(seed, b, h, w, cin, cm, cout, down):
    """Seeded bf16 x in channels_last memory and folded bf16 weights with
    LeCun scale, f32 shifts."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def weight(*shape):
        fan_in = shape[1] * shape[2] * shape[3]
        return (torch.randn(*shape, generator=g, device="cuda") * fan_in ** -0.5).bfloat16()

    def shift(c):
        return torch.randn(c, generator=g, device="cuda") * 0.1

    x = torch.randn(b, cin, h, w, generator=g, device="cuda").bfloat16()
    args = [weight(cm, cin, 1, 1), shift(cm), weight(cm, cm, 3, 3), shift(cm),
            weight(cout, cm, 1, 1), shift(cout)]
    if down:
        args += [weight(cout, cin, 1, 1), shift(cout)]
    return x.contiguous(memory_format=torch.channels_last), args


def _check_against_plain(x, args, bitwise):
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = K.launches
        out = K.fused_bottleneck_cuda(x, *args)
        assert K.launches == before + 1
        ref = K.fused_bottleneck_reference(x, *args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.1, atol=0.15)
    assert abs(float((out.float() - ref.float()).mean())) < 1e-2
    _, exp = math.frexp(max(float(ref.float().abs().max()), 1.0))
    assert float((out.float() - ref.float()).abs().max()) <= 2.0 ** (exp - 8)  # a bf16 ulp
    unequal = float((out.view(torch.int16) != ref.view(torch.int16)).float().mean())
    assert unequal == 0.0 if bitwise else unequal < 0.1


# (batch, H, W, Cin, Cm, Cout, projection): the ResNet-50 blocks of a 640²
# batch of 16, the tests' tiny block, an odd shape, and degenerate ones
SHAPES = [(16, 160, 160, 64, 64, 256, True), (16, 160, 160, 256, 64, 256, False),
          (16, 80, 80, 512, 128, 512, False), (16, 40, 40, 1024, 256, 1024, False),
          (16, 20, 20, 2048, 512, 2048, False), (2, 16, 24, 32, 8, 32, False),
          (2, 16, 24, 32, 8, 32, True), (2, 14, 22, 32, 8, 32, True),
          (1, 1, 1, 64, 16, 64, False), (1, 1, 1, 32, 8, 64, True),
          (3, 8, 8, 64, 16, 64, True), (1, 1, 9, 16, 8, 16, False),
          (2, 9, 1, 16, 8, 24, True), (1, 12, 12, 8, 576, 8, False),
          # v4: each Cm tile (8x16, 10x10, 5x10) at batch 1 and 3, whole and
          # partial tiles, with a projection, and a Cm that is not a power of 2
          (1, 20, 20, 2048, 512, 2048, False), (3, 20, 20, 2048, 512, 2048, False),
          (1, 40, 40, 1024, 256, 1024, False), (3, 40, 40, 1024, 256, 1024, False),
          (2, 16, 16, 64, 64, 256, True), (1, 12, 20, 128, 128, 512, True),
          (1, 10, 10, 256, 256, 1024, True), (1, 5, 10, 512, 512, 2048, True),
          (1, 7, 9, 64, 64, 64, False), (2, 21, 19, 512, 512, 512, False),
          (1, 11, 9, 192, 192, 320, True), (1, 1, 1, 64, 64, 64, False)]


def _variant(cin, cm, cout):
    """The variant the kernel source takes for these channel counts."""
    return 4 if cin % 64 == 0 and cm % 64 == 0 and cout % 64 == 0 and cm <= 512 else 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    _check_against_plain(*_block(sum(shape), *shape), bitwise=shape[3] <= 32 and shape[4] == 8)


@pytest.mark.cuda
def test_dispatch_and_unsupported_shapes_raise():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    x, args = _block(0, 1, 4, 4, 32, 8, 32, True)
    before = K.launches
    K.fused_bottleneck(x, *args)  # a CUDA tensor takes the kernel
    assert K.launches == before + 1
    for shape, match in (((12, 8, 32), "multiples of 8"),
                         ((32, K.max_mid_channels() + 8, 32), "middle channels")):
        xs, bad = _block(0, 1, 4, 4, *shape, True)
        with pytest.raises(ValueError, match=match):
            K.fused_bottleneck_cuda(xs, *bad)
    with pytest.raises(ValueError, match="channels_last"):
        K.fused_bottleneck_cuda(x.contiguous(), *args)
    assert K.launches == before + 1


# the v4 tile (rows, columns) by Cm
V4_TILES = ((64, (8, 16)), (128, (8, 16)), (256, (10, 10)), (512, (5, 10)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_variant_and_tiling_chosen_by_shape(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    b, h, w, cin, cm, cout, _ = shape
    cfg = K.launch_config(b, h, w, cin, cm, cout)
    assert cfg["variant"] == _variant(cin, cm, cout)
    assert cfg["cluster"] == 1 and cfg["ctas_per_sm"] >= 1
    if cfg["variant"] == 4:
        th, tw = next(tile for top, tile in V4_TILES if cm <= top)
    else:
        th, tw = 8, 8
    assert (cfg["tile_h"], cfg["tile_w"]) == (th, tw)
    # one CTA a tile: every output pixel in exactly one
    assert cfg["ctas"] == b * -(-h // th) * -(-w // tw)


@pytest.mark.cuda
def test_resnet50_shapes_take_v4():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for h, cin, cm, cout, ctas in ((160, 64, 64, 256, 3200), (160, 256, 64, 256, 3200),
                                   (80, 512, 128, 512, 800), (40, 1024, 256, 1024, 256),
                                   (20, 2048, 512, 2048, 128)):
        cfg = K.launch_config(16, h, h, cin, cm, cout)
        assert cfg["variant"] == 4 and cfg["ctas"] == ctas


def _module(seed, cin, cm, down):
    g = torch.Generator(device="cuda").manual_seed(seed)
    block = Bottleneck(cin, cm, 1, downsample=down, fused="auto").cuda().eval()
    with torch.no_grad():
        for t in block.parameters():
            t.copy_(torch.randn(t.shape, generator=g, device="cuda") * t[0].numel() ** -0.5)
        for t in block.buffers():
            t.copy_(0.5 + torch.rand(t.shape, generator=g, device="cuda"))
    x = torch.randn(2, cin, 12, 20, generator=g, device="cuda").bfloat16()
    return block, x.contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["running_var", "conv weight", "load_state_dict"])
def test_prepared_block_follows_weight_changes_on_the_card(change):
    """A module's cached bundle (folded weights in the kernel's layout, TMA
    descriptors) is kept across forwards and rebuilt when a weight changes
    on the card; the kernel then matches a fresh fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    block, x = _module(3, 128, 64, True)
    with torch.no_grad():
        first = block(x)
        bundle = block.prepared()
        operands = bundle.operands()
        again = block(x)
        assert block.prepared() is bundle and bundle.operands() is operands
        assert torch.equal(first, again)
        if change == "running_var":
            block.bn2.running_var.mul_(2.0)
        elif change == "conv weight":
            block.conv1.weight.mul_(-1.0)
        else:
            block.load_state_dict(_module(4, 128, 64, True)[0].state_dict())
        before = K.launches
        after = block(x)
        assert K.launches == before + 1
        assert block.prepared() is not bundle
        assert not torch.equal(after, first)
    fresh = [t.clone() if t is not None else None for t in block.prepared().folded]
    block._prepared = None
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(fresh, block.prepared().folded))
    _check_against_plain(x, fresh, bitwise=False)
