"""The port's analysis timers (``object_detectors_tpu_torch/analysis/``) on
the CPU, at tiny sizes: each timer's stages against the JAX
timer's or the port's own call, and the cheap timers' ``main`` printing
one JSON line with every stage. The Faster R-CNN, RetinaNet, training and
serving timers are in ``test_torch_analysis_pipelines.py``.

A JAX timer module points JAX's persistent compile cache into the
repository when imported, so each is imported only inside the test that
needs it, its setting put back after (``jax_timer``).

Tolerances: Darknet prefixes in f32 within 1e-4 (XLA and PyTorch sum the
convolutions in other orders); the proposal filter's boxes within 1e-4
px and scores within 1e-6, kept slots identical; anchors and decoded boxes
bitwise; top-k index sets identical."""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detectors_tpu_torch.analysis import (
    backbone_ablate, darknet_ablate, decode_bench, roialign_bench, rpnfilter_ablate,
    topk_bench,
)
from object_detectors_tpu_torch.models import rpn as RPN
from object_detectors_tpu_torch.utils.weights import flax_yolo_to_torch
from test_torch_yolo import randomize_bn

TINY_DARKNET = (1, 1, 1, 1, 1)
TIMERS = ("darknet_ablate", "backbone_ablate", "frcnn_ablate", "retinanet_ablate",
          "rpnfilter_ablate", "roialign_bench", "topk_bench", "decode_bench", "train_ablate",
          "serving_ablate")


def jax_timer(name):
    """Import the JAX package's ``analysis.<name>`` with JAX's compile-cache
    settings left as they were."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        return importlib.import_module(f"object_detectors_tpu.analysis.{name}")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def one_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.mark.parametrize("n_stages", [0, 2, 5])
def test_darknet_prefix_matches_jax(n_stages):
    J = jax_timer("darknet_ablate")
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    jax_prefix = J.Prefix(n_stages, layers=TINY_DARKNET, dtype=jnp.float32)
    variables = randomize_bn(jax_prefix.init(jax.random.key(0), jnp.asarray(x)), n_stages)
    ref = np.asarray(jax_prefix.apply(variables, jnp.asarray(x)))
    port = darknet_ablate.Prefix(n_stages, TINY_DARKNET)
    port.load_state_dict(flax_yolo_to_torch(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_darknet_main_prints_every_prefix(capsys):
    line = darknet_ablate.main(["--bs", "1", "--size", "64", "--iters", "1", "--device",
                                "cpu"])
    assert one_line(capsys) == line
    assert list(line["stage_ms"]) == ["stem"] + [f"+stage{n}" for n in range(1, 6)]
    assert line["card"] == "none" and line["device"] == "cpu"
    assert all(v > 0 for v in line["stage_ms"].values())


def test_backbone_prefixes_are_the_backbone_s_own_pieces():
    stages, backbone = backbone_ablate.build_stages(torch.float32, layers=(1, 1, 1, 1),
                                                    stem_detail=True, device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        c2_c5 = backbone.resnet(x)
        assert torch.equal(stages["+layer4"](x), c2_c5[-1])
        assert torch.equal(stages["+layer1"](x), c2_c5[0])
        assert stages["+fpn(full)"] is backbone
        assert stages["stem"](x).shape == (1, 64, 16, 16)
        assert torch.equal(stages["stem:pool"](x), stages["stem"](x))
        assert stages["stem:conv"](x).shape == (1, 64, 32, 32)


def test_backbone_main_prints_every_stage(capsys):
    line = backbone_ablate.main(["--bs", "1", "--size", "64", "--iters", "1", "--stem-detail",
                                 "--fused", "--device", "cpu"])
    assert one_line(capsys) == line
    assert list(line["stage_ms"]) == ["stem:conv", "stem:bnrelu", "stem:pool", "stem",
                                      "+layer1", "+layer2", "+layer3", "+layer4",
                                      "+fpn(full)"]
    assert line["fused"] and line["fused_launches"] == 0  # "auto" fuses only on the card


def test_rpnfilter_stages_match_jax_filter():
    J = jax_timer("rpnfilter_ablate")
    size, bs = 64, 2
    level_sizes = rpnfilter_ablate.level_sizes_of(size)
    props, obj = rpnfilter_ablate.make_inputs(bs, size, "cpu")
    cfg = RPN.RPNConfig()
    stages = rpnfilter_ablate.build_stages(level_sizes, (size, size), cfg)
    boxes, scores, valid = stages["full_filter"](props, obj)
    ref = J.RPN.filter_proposals(jnp.asarray(props.numpy()), jnp.asarray(obj.numpy()),
                                 level_sizes, (size, size), J.RPN.RPNConfig())
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(boxes.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref[1]), rtol=0, atol=1e-6)
    lb, flat = stages["plus_nms"](props, obj)
    merged = RPN.merge_survivors(lb, flat, cfg.post_nms_top_n_test)
    assert all(torch.equal(a, b) for a, b in zip(merged, (boxes, scores, valid)))
    tops, ks = stages["topk_only"](props, obj)
    assert ks == list(level_sizes) and [t[0].shape[1] for t in tops] == ks


def test_rpnfilter_main_prints_every_stage(capsys):
    line = rpnfilter_ablate.main(["--bs", "2", "--size", "64", "--iters", "1", "--device",
                                  "cpu"])
    assert one_line(capsys) == line
    assert list(line["stage_ms"]) == ["topk_only", "plus_gather", "plus_nms", "full_filter"]
    assert line["pieces_equal_filter"] and line["nms_launches_per_full_filter"] == 0


def test_decode_layout_and_anchors_match_jax_bitwise():
    J = jax_timer("decode_bench")
    ref = J.level_layout(640)
    got = decode_bench.level_layout(640)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[2] == ref[2] and got[3] == [int(s) for s in ref[3]]
    assert got[4] == list(ref[4]) and got[5] == list(ref[5])
    aidx = np.random.RandomState(2).randint(0, got[0].shape[0], 4000).astype(np.int32)
    aidx[:5] = [0, got[3][1], got[3][4], got[0].shape[0] - 1, got[3][2] - 1]  # level edges
    jax_rows = np.asarray(J.anchors_from_index(jnp.asarray(aidx), *ref[1:]))
    rows = decode_bench.anchors_from_index(torch.from_numpy(aidx), *got[1:]).numpy()
    np.testing.assert_array_equal(rows, jax_rows)
    np.testing.assert_array_equal(rows, got[0].numpy()[aidx])


def test_decode_main_formulations_agree(capsys):
    line = decode_bench.main(["--bs", "2", "--size", "128", "--iters", "1", "--device",
                              "cpu"])
    assert one_line(capsys) == line
    assert list(line["variant_ms"]) == ["fused", "split", "arith"]
    assert line["anchor_mismatches"] == 0 and not any(line["box_mismatches"].values())


def test_topk_variants_select_the_same_sets():
    x = torch.from_numpy(np.random.RandomState(3).randn(3, 3000).astype(np.float32))
    x[0, :40] = 10.0  # 40 tied winners: the JAX order lists them by index
    assert all(topk_bench.check_selections(x, 64).values())
    v, i = topk_bench.variants(64)["sortsel"](x)
    assert i[0, :40].tolist() == list(range(40))


def test_topk_main_prints_every_variant(capsys):
    line = topk_bench.main(["--bs", "2", "--k", "50", "--iters", "1", "--device", "cpu"])
    assert one_line(capsys) == line
    assert list(line["variant_ms"]) == list(topk_bench.SHAPES)
    for v in line["variant_ms"].values():
        assert list(v) == ["topk", "radix", "radix_bf16", "blocked", "sortsel"]


def test_roialign_main_holds_the_pooler_to_plain(capsys):
    line = roialign_bench.main(["--bs", "2", "--rois", "16", "--size", "128", "--ch", "8",
                                "--iters", "1", "--device", "cpu"])
    assert one_line(capsys) == line
    assert list(line["variant_ms"]) == ["noop", "plain_bf16", "kernel_bf16", "plain_f32",
                                        "kernel_f32"]
    # on the CPU the pooler is the plain version itself
    assert line["kernel_max_abs_err"] == {"bf16": 0.0, "f32": 0.0}
    assert line["roi_align_launches"] == 0


def test_timers_run_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    for name in TIMERS:
        timer = importlib.import_module(f"object_detectors_tpu_torch.analysis.{name}")
        with pytest.raises(RuntimeError, match="no GPU"):
            timer.main([])
