"""The port's live serving engine: ODIN reacts to physically injected
interference (mirrors tests/test_serving.py, on the CPU)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import simulate, synthetic_database  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), num_layers=8)
    params = Model(cfg).init_params(0, device="cpu")
    rng = np.random.default_rng(0)
    queries = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))
               for _ in range(40)]
    return cfg, params, queries


def _schedule(q):
    slow = [1.0, 1.0, 1.0, 1.0]
    if 10 <= q < 30:
        slow[1] = 3.0
    return slow


def test_odin_moves_blocks_off_interfered_ep(setup):
    cfg, params, queries = setup
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        device="cpu")
    eng.executor.warmup(1, 64)
    m = eng.serve(queries, _schedule)
    assert m.num_rebalances >= 1
    # during the interference episode ODIN sheds blocks from EP 1
    assert min(c[1] for c in m.configs[15:30]) < 2
    for c in m.configs:                 # every config conserves blocks
        assert sum(c) == cfg.num_blocks
    s = m.summary()
    assert s["mean_latency_s"] > 0
    assert np.isfinite(s["mean_throughput_qps"])
    assert np.isfinite(s["peak_throughput_qps"])
    assert s["p50_latency_s"] <= s["p99_latency_s"]
    assert s["rebalances"] == m.num_rebalances
    assert 0.0 < s["serial_frac"] == float(np.mean(m.serial_mask))
    # trials are charged when a phase commits; one may still be open
    assert m.total_trials <= int(np.sum(m.serial_mask))
    assert sum(m.mitigation_lengths) == m.total_trials


def test_odin_moves_blocks_off_interfered_ep_on_mamba2():
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), num_layers=8)
    params = Model(cfg).init_params(0, device="cpu")
    rng = np.random.default_rng(1)
    queries = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 32)))
               for _ in range(40)]
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        device="cpu")
    eng.executor.warmup(1, 32)
    m = eng.serve(queries, _schedule)
    assert m.num_rebalances >= 1
    assert min(c[1] for c in m.configs[15:30]) < 2
    assert all(sum(c) == cfg.num_blocks for c in m.configs)


def test_static_scheduler_never_rebalances(setup):
    cfg, params, queries = setup
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="none",
                        device="cpu")
    eng.executor.warmup(1, 64)
    m = eng.serve(queries[:20], _schedule)
    assert m.num_rebalances == 0 and m.total_trials == 0
    assert all(c == m.configs[0] == [2, 2, 2, 2] for c in m.configs)
    assert not m.serial_mask.any()


def test_summary_keys_are_jax_trace_keys(setup):
    """The JAX PipelineTrace.summary() keys, all of them: the port's
    serve returns its copy of the trace (mirrors tests/test_serving.py's
    test_serve_metrics_summary_parity_with_simulator)."""
    cfg, params, queries = setup
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="lls",
                        device="cpu")
    live = eng.serve(queries[:6], _schedule).summary()
    sim = simulate(synthetic_database("vgg16", seed=0), 4, scheduler="odin",
                   num_queries=50, freq_period=20, duration=10,
                   seed=0).summary()
    assert set(live) == set(sim)
    for s in (live, sim):
        assert s["p50_latency_s"] <= s["p99_latency_s"]
        assert 0.0 <= s["slo_violations"] <= 1.0
    # closed loop: nothing queues, so latency == service latency
    assert live["mean_latency_s"] == live["mean_service_latency_s"]


def test_reset_policy_restarts_balanced(setup):
    cfg, params, queries = setup
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        device="cpu")
    eng.serve(queries[:14], _schedule)
    eng.reset_policy()
    assert eng.config == [2, 2, 2, 2] and not eng.runtime.exploring
    assert np.isfinite(eng.estimated_peak_throughput())


@pytest.mark.parametrize("arch,args", [
    ("qwen2-0.5b", ["--queries", "12", "--blocks", "4", "--seq", "16",
                    "--freq", "4", "--duration", "4"]),
    ("mamba2-370m", ["--blocks", "2", "--queries", "8", "--seq", "32"]),
])
def test_serve_cli_on_cpu_prints_summary(arch, args):
    env = {"PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", arch, *args, "--json"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    s = json.loads(r.stdout.strip().splitlines()[-1])
    blocks = int(args[args.index("--blocks") + 1])
    assert sum(s["final_config"]) == blocks and s["mean_latency_s"] > 0
