"""The port's step functions and one-card dry run (``repro_torch.launch.steps``,
``repro_torch.launch.dryrun``) on the meta device: parameter and input
shapes and dtypes equal to the JAX package's ``jax.eval_shape`` ones,
FlopCounterMode's count of a train step against ``analytic.py`` as the
JAX test holds the unrolled HLO's (``tests/test_analytic.py``), the cache
bytes of a full-width decode dry run, and the JAX dry run's skips, report
keys and refused options."""
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


def test_cli_writes_a_report_and_refuses_mesh_options(tmp_path, capsys):
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
    for argv in (["--all", "--multi-pod"], ["--all", "--strategy", "tp"]):
        with pytest.raises(SystemExit) as e:
            dryrun.main(argv + ["--out", str(tmp_path)])
        assert e.value.code == 2
        assert "sharding.py" in capsys.readouterr().err


def test_meta_device_only_when_asked():
    assert resolve_device("meta").type == "meta"
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()
