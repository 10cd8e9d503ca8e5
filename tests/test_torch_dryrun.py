"""The port's step functions and one-card dry run (``repro_torch.launch.steps``,
``repro_torch.launch.dryrun``) on the meta device: parameter and input
shapes and dtypes equal to the JAX package's ``jax.eval_shape`` ones,
FlopCounterMode's count of a train step against ``analytic.py`` as the
JAX test holds the unrolled HLO's (``tests/test_analytic.py``), the cache
bytes of a full-width decode dry run, and the JAX dry run's skips, report
keys, the production meshes' per-device argument bytes against JAX's
shard shapes and ``auto_strategy``, and the pipeline dry run."""
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS,
    INPUT_SHAPES,
    get_config,
    get_smoke_config,
    shape_is_applicable,
)
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.analytic import analytic_cost, analytic_totals  # noqa: E402
from repro_torch.training.checkpoint import flatten  # noqa: E402
from repro_torch.util.device import resolve_device  # noqa: E402

MODES = ("train", "prefill", "decode")


def _jax_leaves(tree):
    return {jax.tree_util.keystr(path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    out = {}
    for path, t in flatten(tree).items():
        assert t.device.type == "meta", path
        out[path] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_equal_jax_eval_shape(arch):
    got = _port_leaves(steps.param_shapes(get_smoke_config(arch)))
    want = _jax_leaves(jax_steps.param_shapes(jax_smoke(arch)))
    assert got == want


@pytest.mark.parametrize("arch,mode", [
    (a, m) for a in ARCH_IDS for m in MODES
    if m != "decode" or get_smoke_config(a).is_decoder])
def test_input_specs_equal_jax(arch, mode):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    shape = InputShape("x", 64, 2, mode)
    got = _port_leaves(steps.input_specs(cfg, shape))
    want = _jax_leaves(jax_steps.input_specs(jcfg, shape))
    assert got == want


def test_opt_state_shapes_are_fp32_like_the_params():
    params = steps.param_shapes(get_smoke_config("qwen2-0.5b"))
    opt = steps.opt_state_shapes(params)
    for k in ("m", "v"):
        for (p1, t), (p2, p) in zip(flatten(opt[k]).items(),
                                    flatten(params).items()):
            assert p1 == p2 and t.shape == p.shape
            assert t.dtype == torch.float32 and t.device.type == "meta"


def test_resolve_config_takes_the_sliding_window_variant():
    shape = INPUT_SHAPES["long_500k"]
    cfg = steps.resolve_config(get_config("qwen3-4b"), shape)
    assert cfg.sliding_window == 8192 and cfg.name == "qwen3-4b-swa"
    assert steps.resolve_config(get_config("mamba2-370m"), shape) \
        == get_config("mamba2-370m")
    with pytest.raises(ValueError, match="encoder-only"):
        steps.resolve_config(get_config("hubert-xlarge"), shape)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b",
                                  "mamba2-370m", "hubert-xlarge"])
def test_flop_counter_vs_analytic_train(arch):
    """FlopCounterMode's count of the meta-device train step agrees with
    the analytic model within 25%, the JAX test's limit for the HLO's."""
    cfg = get_smoke_config(arch)
    shape = InputShape("tiny_train", 128, 4, "train")
    counted = dryrun.run_step(cfg, shape)["counted_flops"]
    ana = analytic_totals(cfg, shape, remat=True)["flops"]
    assert counted == pytest.approx(ana, rel=0.25)


def test_full_width_decode_reports_the_analytic_cache_bytes():
    shape = INPUT_SHAPES["decode_32k"]
    cfg = get_config("qwen3-4b")
    rep = dryrun.dry_run("qwen3-4b", "decode_32k", verbose=False)
    mem = rep["memory"]
    assert mem["cache_bytes"] == analytic_cost(cfg, shape).kv_bytes_step
    assert mem["argument_bytes"] == (mem["params_bytes"] + mem["cache_bytes"]
                                     + mem["input_bytes"])
    assert mem["params_bytes"] == sum(
        t.numel() * t.element_size()
        for t in flatten(steps.param_shapes(cfg)).values())
    assert mem["fits_one_card"] is False       # 576 GiB of cache
    assert rep["roofline"]["bottleneck"] == "memory"
    assert rep["chips"] == 1 and rep["mode"] == "decode"
    for key in ("mesh", "strategy", "compile_s"):
        assert rep[key].startswith("none:")
    assert rep["roofline"]["collective_breakdown"].startswith("none:")
    assert rep["flops_check"]["ratio"] == pytest.approx(1.0, rel=0.01)


def test_train_report_counts_gradients_and_saved_activations():
    cfg = get_smoke_config("qwen2-0.5b")
    shape = InputShape("x", 128, 4, "train")
    mem = dryrun.run_step(cfg, shape)["memory"]
    assert mem["grad_bytes"] == mem["params_bytes"]
    assert mem["opt_state_bytes"] == 2 * 2 * mem["params_bytes"] + 4
    x = 4 * 128 * cfg.d_model * 2
    assert mem["saved_activation_bytes"] > cfg.num_blocks * x
    assert mem["total_bytes"] >= mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["fits_one_card"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skips_what_the_jax_dry_run_skips(arch):
    for name, shape in INPUT_SHAPES.items():
        ok, why = shape_is_applicable(get_config(arch), shape)
        skipped = not ok and not (name == "long_500k"
                                  and get_config(arch).is_decoder)
        if skipped:
            rep = dryrun.dry_run(arch, name, verbose=False)
            assert rep == {"arch": arch, "shape": name, "skipped": True,
                           "reason": why}
    assert (not get_config(arch).is_decoder) == (arch == "hubert-xlarge")


def test_cli_writes_a_report_and_takes_mesh_options(tmp_path):
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    rep = json.loads((tmp_path / "hubert-xlarge__decode_32k__1xh100.json")
                     .read_text())
    assert rep["skipped"] and "encoder-only" in rep["reason"]
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    rep = json.loads((tmp_path / "qwen2-0.5b__long_500k__1xh100.json")
                     .read_text())
    assert rep["variant"] == "sliding_window" and not rep["skipped"]
    assert rep["mesh"].startswith("none:") and rep["chips"] == 1
    # The production meshes: JAX's file names and report keys.
    for argv, name, mesh, chips, strategy in (
            (["--multi-pod"], "2x16x16", "2x16x16", 512, "tp"),
            (["--strategy", "zero3"], "16x16", "16x16", 256, "zero3")):
        assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                            "--out", str(tmp_path)] + argv) == 0
        rep = json.loads((tmp_path / f"qwen2-0.5b__decode_32k__{name}.json")
                         .read_text())
        assert (rep["mesh"], rep["chips"], rep["strategy"]) == (
            mesh, chips, strategy)
        assert rep["roofline"]["collective_bytes"].startswith("none:")
        assert rep["memory"]["fits_one_card"] is True
    assert not torch.distributed.is_initialized()


def _jax_dryrun():
    """The JAX dry run module; its import sets XLA_FLAGS for 512 host
    devices, which is undone so that no later JAX backend takes it."""
    import os
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jax_dryrun


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_auto_strategy_equals_jax(arch):
    from repro.configs import get_config as jax_config
    jax_dryrun = _jax_dryrun()
    for name, shape in INPUT_SHAPES.items():
        cfg, jcfg = get_config(arch), jax_config(arch)
        if name == "long_500k" and cfg.is_decoder:
            cfg = steps.resolve_config(cfg, shape)
            jcfg = jax_steps.resolve_config(jcfg, shape)
        assert dryrun.auto_strategy(cfg, shape) == \
            jax_dryrun.auto_strategy(jcfg, shape), name


def _jax_shardings(tree):
    from jax.sharding import NamedSharding
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))


@pytest.mark.parametrize("arch,shape_name,multi_pod,strategy", [
    ("qwen2-0.5b", "train_4k", False, "fsdp_all"),   # batch over 256
    ("qwen2-0.5b", "prefill_32k", True, None),       # auto: dp_seq
    ("qwen2-0.5b", "decode_32k", True, None),        # auto: tp
    ("mamba2-370m", "decode_32k", False, "zero3"),
])
def test_sharded_argument_bytes_equal_jax_shard_sum(arch, shape_name,
                                                    multi_pod, strategy):
    """Per-device argument bytes: params, ZeRO-1 optimizer state, batch
    and cache, each leaf's bytes over JAX's ``shard_shape``."""
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jax_config
    from repro.launch import sharding as jax_sh
    jax_dryrun = _jax_dryrun()
    rep = dryrun.dry_run(arch, shape_name, verbose=False,
                         multi_pod=multi_pod, strategy=strategy)
    shape = INPUT_SHAPES[shape_name]
    jcfg = jax_config(arch)
    want_strategy = strategy or jax_dryrun.auto_strategy(jcfg, shape)
    amesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model"))
             if multi_pod else AbstractMesh((16, 16), ("data", "model")))
    params = jax_steps.param_shapes(jcfg)
    specs = jax_steps.input_specs(jcfg, shape)
    psh = jax_sh.params_shardings(params, amesh, want_strategy, cfg=jcfg)
    pairs = [(params, psh)]
    if shape.mode == "train":
        opt = jax_steps.opt_state_shapes(params)
        pairs += [(opt, jax_sh.opt_state_shardings(opt, psh, amesh,
                                                   want_strategy)),
                  (specs["batch"], jax_sh.batch_pspec(specs["batch"], amesh,
                                                      want_strategy))]
    elif shape.mode == "prefill":
        pairs.append((specs, jax_sh.batch_pspec(specs, amesh,
                                                want_strategy)))
    else:
        pairs += [(specs["tokens"], jax_sh.batch_pspec(specs["tokens"],
                                                       amesh)),
                  (specs["cache"], jax_sh.cache_shardings(
                      specs["cache"], amesh, shape.global_batch)),
                  (specs["index"], None)]
    want = 0
    for tree, shardings in pairs:
        leaves = jax.tree_util.tree_leaves(tree)
        if shardings is None:
            want += sum(x.size * x.dtype.itemsize for x in leaves)
            continue
        for x, ns in zip(leaves, _jax_shardings(shardings)):
            n = 1
            for d in ns.shard_shape(x.shape):
                n *= d
            want += n * x.dtype.itemsize
    mem = rep["memory"]
    assert (rep["strategy"], rep["chips"]) == (want_strategy,
                                               512 if multi_pod else 256)
    assert mem["argument_bytes"] == want
    assert mem["argument_bytes"] == (mem["params_bytes"]
                                     + mem["opt_state_bytes"]
                                     + mem["input_bytes"]
                                     + mem["cache_bytes"])
    assert mem["total_bytes"] >= mem["argument_bytes"]
    assert mem["fits_one_card"] == (mem["total_bytes"] <= 80 * 2 ** 30)


def test_pipeline_dry_run_bytes_and_middle_rank_collectives(capsys):
    """One middle-stage rank of the pipeline on both production meshes:
    its tile's bytes against JAX's packed stage params sharded on the
    stage axis, and the hand-offs it sends."""
    import dataclasses
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    from repro.pipeline import spmd as jax_spmd
    from repro_torch.launch import dryrun_pipeline
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), num_layers=32)
    jcfg = dataclasses.replace(jax_smoke("qwen3-8b"), num_layers=32)
    M, mb, S = 3, 1, 16
    for multi_pod in (False, True):
        r = dryrun_pipeline.pipeline_dry_run(cfg, multi_pod=multi_pod,
                                             microbatch=M, mb_rows=mb,
                                             seq=S)
        amesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model"))
                 if multi_pod else AbstractMesh((16, 16), ("data", "model")))
        blocks = jax_steps.param_shapes(jcfg)["blocks"]
        stage_sh = jax.eval_shape(lambda bp: jax_spmd.pack_stage_params(
            bp, [2] * 16, 4), blocks)
        tile = 0
        for x in jax.tree_util.tree_leaves(stage_sh):
            n = 1
            for d in NamedSharding(amesh, P("data")).shard_shape(x.shape):
                n *= d
            tile += n * x.dtype.itemsize
        hand_off = mb * S * cfg.d_model * 2
        assert (r["n_stages"], r["cap"], r["counts"]) == (16, 4, [2] * 16)
        assert r["chips_per_stage"] == (32 if multi_pod else 16)
        assert r["tile_bytes"] == tile
        assert r["argument_bytes"] == tile + 4 * 16 + M * hand_off
        assert (r["rank"], r["stage"], r["sends"]) == (128, 8, M)
        assert r["collectives"]["collective-permute"] == M * hand_off
        assert r["collectives"]["all-reduce"] == M * hand_off
        assert r["compiled"].startswith("none:")
    assert not torch.distributed.is_initialized()
    assert dryrun_pipeline.main(["--arch", "qwen2-0.5b", "--multi-pod",
                                 "--seq", "16", "--mb-rows", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[pipeline-dryrun] qwen2-0.5b: 16 stages x "
                             "32 chips, cap=4, compiled in none:")
    assert "args/device" in out[1] and "rank 128 (stage 8 of 16" in out[2]


def test_meta_device_only_when_asked():
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
