"""The port's fused bottleneck (object_detectors_tpu_torch/kernels/fused_block.py
and the ``fused`` knob of models/resnet.py) against the JAX package's
kernels/fused_block.py (``fold_bn``, ``fused_bottleneck`` in interpret mode)
and its Flax Bottleneck / ResNet, on the same numpy inputs, at the
tolerances of tests/test_fused_block.py."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from object_detectors_tpu.kernels import fused_block as JFB
from object_detectors_tpu.models import resnet as JR
from object_detectors_tpu_torch.kernels import fused_block as FB
from object_detectors_tpu_torch.models import resnet as R
from object_detectors_tpu_torch.utils.weights import flax_frcnn_to_torch

ROOT = Path(__file__).resolve().parents[1]
CIN, CM, COUT = 32, 8, 32
B, H, W = 2, 16, 24


def _bn(rng, c):
    return {"weight": rng.rand(c).astype(np.float32) + 0.5,
            "bias": rng.randn(c).astype(np.float32) * 0.1,
            "running_mean": rng.randn(c).astype(np.float32) * 0.1,
            "running_var": rng.rand(c).astype(np.float32) + 0.5}


def _torch_bf16(a: jnp.ndarray) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor with the same bits."""
    bits = np.asarray(a.view(jnp.uint16)).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _torch_bn(bn):
    return {k: torch.from_numpy(v) for k, v in bn.items()}


def _oihw(kernel_hwio) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel_hwio).transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", [(16, 32, 1, 1), (8, 8, 3, 3), (256, 64, 1, 1)])
def test_fold_bn_is_bitwise_jax(shape):
    rng = np.random.RandomState(shape[0])
    weight = rng.randn(*shape).astype(np.float32) * 0.2
    bn = _bn(rng, shape[0])
    w, shift = FB.fold_bn(torch.from_numpy(weight), _torch_bn(bn))
    ref_w, ref_shift = JFB.fold_bn(jnp.asarray(weight.transpose(2, 3, 1, 0)),
                                   {k: jnp.asarray(v) for k, v in bn.items()})
    assert w.dtype == torch.bfloat16 and shift.dtype == torch.float32
    np.testing.assert_array_equal(w.permute(2, 3, 1, 0).contiguous().view(torch.int16).numpy(),
                                  np.asarray(ref_w.view(jnp.uint16)).view(np.int16))
    np.testing.assert_array_equal(shift.numpy().view(np.int32),
                                  np.asarray(ref_shift).view(np.int32))


def _block_case(has_down, seed):
    """The inputs of tests/test_fused_block.py: a Flax Bottleneck (Cin 32,
    Cm 8) with random weights and frozen statistics, its JAX output, the
    JAX fused kernel's output (interpret mode) and the port's folded
    weights."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(B, H, W, CIN).astype(np.float32), jnp.bfloat16)
    block = JR.Bottleneck(CM, 1, downsample=has_down, norm="frozen", dtype=jnp.bfloat16,
                          expansion=COUT // CM)
    variables = block.init(jax.random.key(seed), x, False)
    params = jax.tree.map(
        lambda p: np.random.RandomState(seed + 1).randn(*p.shape).astype(np.float32) * 0.2,
        variables["params"])
    frozen = {k: _bn(rng, v["weight"].shape[0]) for k, v in variables["frozen"].items()}
    flax_out = block.apply({"params": params, "frozen": frozen}, x, False)

    names = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
    if has_down:
        names.append(("down_conv", "down_bn"))
    jax_args, port_args = [], []
    for conv, bn in names:
        kernel = params[conv]["kernel"]
        jax_args += JFB.fold_bn(jnp.asarray(kernel if conv == "conv2" else kernel[0, 0]),
                                {k: jnp.asarray(v) for k, v in frozen[bn].items()})
        port_args += FB.fold_bn(_oihw(kernel), _torch_bn(frozen[bn]))
    kernel_out = JFB.fused_bottleneck(x, *jax_args, tr=8, interpret=True)
    xt = _torch_bf16(x).permute(0, 3, 1, 2)
    state = flax_frcnn_to_torch(params, frozen)
    return (xt, port_args, np.asarray(kernel_out, np.float32), np.asarray(flax_out, np.float32),
            state)


def _assert_block_close(out: torch.Tensor, ref: np.ndarray, atol=0.15, mean=1e-2):
    got = out.float().permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0.1, atol=atol)
    assert abs(float(np.mean(got - ref))) < mean
    return float(np.abs(got - ref).max())


@pytest.mark.parametrize("has_down,seed", [(False, 0), (True, 1)])
def test_reference_matches_jax_kernel_and_flax_block(has_down, seed):
    x, args, kernel_ref, flax_ref, _ = _block_case(has_down, seed)
    out = FB.fused_bottleneck_reference(x, *args)
    assert out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=torch.channels_last)
    _assert_block_close(out, kernel_ref)
    _assert_block_close(out, flax_ref)
    # the CPU dispatch is the plain version
    assert torch.equal(FB.fused_bottleneck(x, *args), out)


@pytest.mark.parametrize("has_down,seed", [(False, 0), (True, 1)])
def test_port_bottleneck_module_matches_jax_kernel(has_down, seed):
    """The port's Bottleneck with fused="interpret" folds its own weights
    as the JAX module does."""
    x, args, kernel_ref, flax_ref, state = _block_case(has_down, seed)
    block = R.Bottleneck(CIN, CM, 1, downsample=has_down, fused="interpret")
    block.load_state_dict(state)
    folded = block.eval().folded()
    assert all(torch.equal(a, b) for a, b in zip(folded, args))
    assert (folded[6] is None) == (not has_down)
    assert block.uses_fused(x)
    with torch.no_grad():
        _assert_block_close(block(x), kernel_ref)
        block.fused = "off"  # the unfused path against the Flax block
        _assert_block_close(block(x), flax_ref)


def _wrong_chain(x, w1, b1, w2, b2, w3, b3, wd, bd, mistake):
    """The plain chain with one of two mistakes a kernel could make: conv2
    padded with relu(b1) (the value t1 would have outside the image) instead
    of zeros, or t1 and t2 kept in f32 instead of rounded to bf16."""
    def conv(t, wt, shift, padding=0):
        return F.conv2d(t, wt.float(), padding=padding) + shift.float()[:, None, None]

    t1 = F.relu(conv(x.float(), w1, b1))
    if mistake == "pad relu(b1)":
        t1 = t1.bfloat16().float()
        fill = F.relu(b1)[None, :, None, None].expand(*t1.shape[:2], t1.shape[2] + 2,
                                                       t1.shape[3] + 2).clone()
        fill[:, :, 1:-1, 1:-1] = t1
        t2 = F.relu(conv(fill, w2, b2)).bfloat16().float()
    else:
        t2 = F.relu(conv(t1, w2, b2, 1))
    ident = x.float() if wd is None else conv(x.float(), wd, bd)
    return F.relu(conv(t2, w3, b3) + ident).bfloat16()


def _wide_case():
    """A ResNet-like block (Cin 256, Cm 64) with seeded folded weights."""
    g = torch.Generator().manual_seed(7)
    block = R.Bottleneck(256, 64, 1).eval()
    with torch.no_grad():
        for t in block.parameters():
            t.copy_(torch.randn(t.shape, generator=g) * t[0].numel() ** -0.5)
        for name, t in block.named_buffers():
            t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75
                    if name.endswith(("weight", "running_var"))
                    else torch.randn(t.shape, generator=g) * 0.1)
    x = torch.randn(2, 256, 40, 40, generator=g).bfloat16()
    return x.contiguous(memory_format=torch.channels_last), list(block.folded())


@pytest.mark.parametrize("small", [True, False])
@pytest.mark.parametrize("mistake", ["pad relu(b1)", "f32 t1 and t2"])
def test_smoke_agreement_checks_reject_wrong_chains(mistake, small):
    """chip_smoke holds the kernel to its plain version within one bf16 ulp
    of max(|plain|, 1), with under a tenth of the elements not bitwise equal
    and none at the small shapes: a kernel with either mistake fails that at
    the tiny block and at a wide one (the JAX test's tolerance alone can let
    both through)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x, args = _block_case(True, 1)[:2] if small else _wide_case()
    ref = FB.fused_bottleneck_reference(x, *args)
    assert smoke.fused_agreement(ref, ref, small) == (0.0, 0.0, True)
    assert not smoke.fused_agreement(_wrong_chain(x, *args, mistake), ref, small)[2]


def _resnet_pair(fused):
    """JAX ResNet((1, 1)) in bf16 and the port's with the same weights."""
    x = jnp.asarray(np.random.RandomState(0).randn(1, 32, 32, 3).astype(np.float32),
                    jnp.bfloat16)
    jax_model = JR.ResNet((1, 1), "bottleneck", "frozen", jnp.bfloat16, fused=fused)
    v = jax_model.init(jax.random.key(0), x, False)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    rng = np.random.RandomState(5)
    v["frozen"] = jax.tree_util.tree_map(
        lambda a: (rng.rand(*a.shape) * 0.5 + 0.75).astype(np.float32), v["frozen"])
    port = R.ResNet((1, 1), fused=fused)
    port.load_state_dict(flax_frcnn_to_torch(v["params"], v["frozen"]))
    xt = _torch_bf16(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return jax_model, v, x, port.eval(), xt


def test_resnet_fused_interpret_matches_jax():
    jax_model, v, x, port, xt = _resnet_pair("interpret")
    ref = jax_model.apply(v, x, False)
    with torch.no_grad():
        out = port(xt)
    assert len(out) == len(ref) == 2
    for o, r in zip(out, ref):
        _assert_block_close(o, np.asarray(r, np.float32), atol=0.2, mean=2e-2)


def test_resnet_fused_auto_on_cpu_equals_off():
    *_, port, xt = _resnet_pair("auto")
    with torch.no_grad():
        auto = port(xt)
        R.set_fused(port, "off")
        off = port(xt)
    assert all(torch.equal(a, o) for a, o in zip(auto, off))
    assert not any(m.uses_fused(xt) for m in port.modules() if isinstance(m, R.Bottleneck))


def test_fused_gate():
    """Only eval, stride 1, bf16 and an even height take the fused path."""
    block = R.Bottleneck(32, 8, 1, downsample=True, fused="interpret").eval()
    x = torch.zeros(1, 32, 6, 6, dtype=torch.bfloat16)
    assert block.uses_fused(x)
    assert not block.uses_fused(x.float())
    assert not block.uses_fused(torch.zeros(1, 32, 5, 6, dtype=torch.bfloat16))
    assert not R.Bottleneck(32, 8, 2, downsample=True, fused="interpret").eval().uses_fused(x)
    assert not block.train().uses_fused(x)
    with pytest.raises(ValueError, match="fused must be one of"):
        R.Bottleneck(32, 8, fused="on")


def _zeros(cin, cm, cout, down=True):
    bf = dict(dtype=torch.bfloat16)
    args = [torch.zeros(cm, cin, 1, 1, **bf), torch.zeros(cm), torch.zeros(cm, cm, 3, 3, **bf),
            torch.zeros(cm), torch.zeros(cout, cm, 1, 1, **bf), torch.zeros(cout)]
    if down:
        args += [torch.zeros(cout, cin, 1, 1, **bf), torch.zeros(cout)]
    return torch.zeros(1, cin, 4, 4, **bf).contiguous(memory_format=torch.channels_last), args


def test_cuda_wrapper_checks_its_inputs():
    """The checks that run before a launch; the launch itself needs a card
    (tests/test_torch_fused_block_cuda.py)."""
    x, args = _zeros(32, 8, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        FB.fused_bottleneck_cuda(x, *args)
    with pytest.raises(ValueError, match="multiples of 8"):
        x12, args12 = _zeros(12, 8, 32)
        FB.fused_bottleneck_cuda(x12, *args12)
    with pytest.raises(TypeError, match="bf16 x"):
        FB.fused_bottleneck_cuda(x.float(), *args)
    with pytest.raises(ValueError, match="Cout == Cin"):
        x64, args64 = _zeros(32, 8, 64, down=False)
        FB.fused_bottleneck_cuda(x64, *args64)
    with pytest.raises(ValueError, match="shape"):
        FB.fused_bottleneck_cuda(x, *args[:2], args[2][:, :, :1], *args[3:])
    with pytest.raises(TypeError, match="shifts must be float32"):
        FB.fused_bottleneck_cuda(x, args[0], args[1].double(), *args[2:])


def _seeded_block(seed, cin=32, cm=8, down=True):
    """A port Bottleneck in eval with seeded weights and frozen statistics."""
    g = torch.Generator().manual_seed(seed)
    block = R.Bottleneck(cin, cm, 1, downsample=down, fused="interpret").eval()
    with torch.no_grad():
        for t in block.parameters():
            t.copy_(torch.randn(t.shape, generator=g) * t[0].numel() ** -0.5)
        for name, t in block.named_buffers():
            t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.75)
    return block


def _fresh_fold(block):
    pairs = [(block.conv1, block.bn1), (block.conv2, block.bn2), (block.conv3, block.bn3),
             (block.down_conv, block.down_bn)]
    return [t for conv, bn in pairs for t in FB.fold_bn(conv.weight, dict(bn.named_buffers()),
                                                         bn.eps)]


def _count_folds(monkeypatch):
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return FB.fold_bn(*args, **kwargs)

    monkeypatch.setattr(R, "fold_bn", counting)
    return calls


def test_fold_is_cached(monkeypatch):
    """A second prepared()/folded() returns the cached tensors and folds
    nothing."""
    block = _seeded_block(0)
    first = block.prepared()
    calls = _count_folds(monkeypatch)
    assert block.prepared() is first
    again = block.folded()
    assert all(a is b for a, b in zip(again, first.folded))
    assert calls == []
    assert all(torch.equal(a, b) for a, b in zip(again, _fresh_fold(block)))


def _change(block, what):
    with torch.no_grad():
        if what == "running_var":
            block.bn2.running_var.mul_(1.5)
        elif what == "conv weight":
            block.conv3.weight.add_(0.25)
        elif what == "down_bn bias":
            block.down_bn.bias[3] = 2.0
        elif what == "load_state_dict":
            block.load_state_dict(_seeded_block(9).state_dict())
        elif what == "to float64 and back":
            block.double().float()


@pytest.mark.parametrize("what", ["running_var", "conv weight", "down_bn bias",
                                  "load_state_dict", "to float64 and back"])
def test_fold_cache_rebuilds_after_a_change(monkeypatch, what):
    block = _seeded_block(1)
    before = block.prepared()
    stale = [t.clone() for t in before.folded]
    _change(block, what)
    calls = _count_folds(monkeypatch)
    after = block.prepared()
    assert after is not before and len(calls) == 4
    fresh = _fresh_fold(block)
    assert all(torch.equal(a, b) for a, b in zip(after.folded, fresh))
    if what != "to float64 and back":  # that one leaves the values as they were
        assert not all(torch.equal(a, b) for a, b in zip(stale, fresh))
    assert block.prepared() is after and len(calls) == 4


def test_fold_cache_built_in_inference_mode_serves_no_grad():
    block = _seeded_block(2)
    x = torch.randn(1, 32, 6, 6, generator=torch.Generator().manual_seed(3)).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        inside = block(x)
    cached = block.prepared()
    assert not any(t.is_inference() for t in cached.folded if t is not None)
    assert not any(t.requires_grad for t in cached.folded if t is not None)
    with torch.no_grad():
        outside = block(x)
    assert block.prepared() is cached
    assert torch.equal(inside, outside)


def test_warm_resnet_forward_folds_nothing_and_matches_jax(monkeypatch):
    """A second forward of the fused ResNet takes every block's cached
    bundle: no fold and no new bundle, and it still matches JAX."""
    jax_model, v, x, port, xt = _resnet_pair("interpret")
    with torch.no_grad():
        cold = port(xt)
    bundles = []
    init = FB.PreparedBlock.__init__

    def counting_init(self, *args):
        bundles.append(1)
        init(self, *args)

    monkeypatch.setattr(FB.PreparedBlock, "__init__", counting_init)
    calls = _count_folds(monkeypatch)
    with torch.no_grad():
        warm = port(xt)
    assert calls == [] and bundles == []
    assert all(torch.equal(a, b) for a, b in zip(cold, warm))
    for o, r in zip(warm, jax_model.apply(v, x, False)):
        _assert_block_close(o, np.asarray(r, np.float32), atol=0.2, mean=2e-2)


def test_prepared_block_wrapper_checks_its_inputs():
    """The prepared-block kernel wrapper refuses a CPU tensor and a channel
    count the block does not take (the launch itself needs a card); a block
    is checked when it is prepared."""
    prepared = _seeded_block(4).prepared()
    x = torch.randn(2, 32, 6, 8, generator=torch.Generator().manual_seed(5)).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="CUDA device"):
        FB.fused_block_cuda(x, prepared)
    with pytest.raises(ValueError, match="channels"):
        FB.fused_block_cuda(x[:, :16], prepared)
    with pytest.raises(TypeError, match="bf16 x"):
        FB.fused_block_cuda(x.float(), prepared)
    with pytest.raises(ValueError, match="Cout == Cin"):
        FB.PreparedBlock(*_zeros(32, 8, 64, down=False)[1])
