"""The port's batched and open-loop serving on the CPU: the live engine's
formed dispatches, joins and queueing against the JAX engine, on the same
weights (mirrors tests/test_continuous_batching.py and the batching tests
of tests/test_serving.py)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import simulate, synthetic_database  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.pipeline.executor import (  # noqa: E402
    LocalPipelineExecutor as JaxExecutor,
)
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.pipeline.executor import (  # noqa: E402
    LocalPipelineExecutor,
    next_pow2,
)
from repro_torch.schedulers.runtime import RuntimeStep  # noqa: E402
from repro_torch.serving import ServeMetrics, ServingEngine  # noqa: E402
from repro_torch.util.errors import MixedSequenceLengthError  # noqa: E402
from repro_torch.workloads import PipelineTrace, resolve_batching  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: tests/test_continuous_batching.py's LOCKED simulator configuration.
LOCKED = dict(
    scheduler="none", events=[], num_queries=800,
    workload="bursty",
    workload_kwargs=dict(rate=0.0035, burst_rate=0.007, burst_prob=0.05,
                         seed=7),
    max_batch=16, buckets="pow2:64:512",
    lengths="bimodal",
    lengths_kwargs=dict(short=48, long=420, p_long=0.1, seed=11),
    batch_overhead=30.0,
)


def _models(arch: str, layers: int, key: int):
    jcfg = dataclasses.replace(jax_smoke(arch), num_layers=layers)
    jparams = JaxModel(jcfg).init_params(jax.random.PRNGKey(key),
                                         jnp.float32)
    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=layers)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def live_setup():
    """tests/test_continuous_batching.py's live_setup: qwen2-0.5b smoke at
    8 layers, 24 queries of 32 or 64 tokens."""
    jcfg, jparams, cfg, params = _models("qwen2-0.5b", 8, 0)
    rng = np.random.default_rng(0)
    tokens = [rng.integers(0, cfg.vocab_size,
                           (1, 64 if rng.random() < 0.3 else 32))
              for _ in range(24)]
    return jcfg, jparams, cfg, params, tokens


@pytest.fixture(scope="module")
def mamba_setup():
    """A 2-block mamba2-370m smoke config, queries of 32 or 64 tokens."""
    jcfg, jparams, cfg, params = _models("mamba2-370m", 2, 1)
    rng = np.random.default_rng(1)
    tokens = [rng.integers(0, cfg.vocab_size,
                           (1, 64 if rng.random() < 0.3 else 32))
              for _ in range(24)]
    return jcfg, jparams, cfg, params, tokens


@pytest.fixture(scope="module")
def setup():
    """tests/test_serving.py's setup: 40 queries of 64 tokens."""
    jcfg, jparams, cfg, params = _models("qwen2-0.5b", 8, 0)
    rng = np.random.default_rng(0)
    tokens = [rng.integers(0, cfg.vocab_size, (1, 64)) for _ in range(40)]
    return cfg, params, [torch.from_numpy(t) for t in tokens]


@pytest.fixture(scope="module")
def sim_keys():
    """The simulator's summary keys for a formed-dispatch run (the locked
    configuration above)."""
    return set(simulate(synthetic_database("vgg16", seed=0), 8,
                        batching="continuous", **LOCKED).summary())


def _port_queries(tokens):
    return [torch.from_numpy(t) for t in tokens]


def _live_schedule(q):
    slow = [1.0] * 4
    if 6 <= q < 16:
        slow[1] = 2.0
    return slow


_LIVE_KW = dict(workload="bursty",
                workload_kwargs=dict(rate=30.0, burst_rate=300.0,
                                     burst_prob=0.2, seed=1),
                batching="continuous", max_batch=4, buckets="pow2:32:64")


@pytest.mark.parametrize("which", ["qwen2-0.5b", "mamba2-370m"])
def test_live_continuous_serve_smoke(which, live_setup, mamba_setup,
                                     sim_keys):
    """tests/test_continuous_batching.py::test_live_continuous_serve_smoke
    on the port (and on a Mamba2 model)."""
    _, _, cfg, params, tokens = (live_setup if which == "qwen2-0.5b"
                                 else mamba_setup)
    queries = _port_queries(tokens)
    eps = 4 if which == "qwen2-0.5b" else 2
    eng = ServingEngine(cfg, params, num_eps=eps, scheduler="odin", alpha=3,
                        device="cpu")
    m = eng.serve(queries, lambda q: _live_schedule(q)[:eps], **_LIVE_KW)
    assert isinstance(m, PipelineTrace) and ServeMetrics is PipelineTrace
    s = m.summary()
    assert len(m.latencies) == len(queries)
    assert s["mean_batch_occupancy"] >= 1.0
    # sim/live summary parity holds for formed-dispatch runs too
    assert set(s) == sim_keys
    assert np.all(m.queue_delays >= 0)
    assert np.all(m.service_latencies > 0)
    assert all(sum(c) == cfg.num_blocks for c in m.configs)
    # the warmed shapes are the closed pow2-rows x bucket-edges family
    edges = (32, 64)
    assert eng.executor._warmed
    for rows, seq in eng.executor._warmed:
        assert seq in edges and rows == next_pow2(rows)

    # a fresh serve over warm shapes must not warm anything: any
    # ensure_warm miss would call warmup and raise here
    def no_warmups(*a, **k):
        raise AssertionError(f"warmup requested in warm serve: {a}")

    eng.reset_policy()
    eng.executor.warmup = no_warmups
    m2 = eng.serve(queries, lambda q: _live_schedule(q)[:eps], **_LIVE_KW)
    assert len(m2.latencies) == len(queries)


def test_run_batch_typed_error_and_no_copy(live_setup):
    """tests/test_continuous_batching.py::test_run_batch_typed_error_and_no_copy
    on the port's executor."""
    _, _, cfg, params, tokens = live_setup
    queries = _port_queries(tokens)
    ex = LocalPipelineExecutor(cfg, params, device="cpu")
    config = [2, 2, 2, 2]
    q32 = next(q for q in queries if q.shape[-1] == 32)
    q64 = next(q for q in queries if q.shape[-1] == 64)
    with pytest.raises(MixedSequenceLengthError) as ei:
        ex.run_batch([q32, q64, q32], config)
    assert ei.value.lengths == [32, 64, 32]
    assert "32" in str(ei.value) and "64" in str(ei.value)
    assert isinstance(ei.value, ValueError)
    # a single-query dispatch forwards the tokens object untouched
    seen = {}
    orig = ex.run_query

    def spy(tokens, config, slowdowns=None):
        seen["tokens"] = tokens
        return orig(tokens, config, slowdowns=slowdowns)

    ex.run_query = spy
    try:
        logits, stage_times = ex.run_batch([q32], config)
    finally:
        ex.run_query = orig
    assert seen["tokens"] is q32
    assert logits.shape[0] == 1 and stage_times.shape == (4,)


def test_batched_serve_accounting_parity(setup):
    """tests/test_serving.py::test_batched_serve_accounting_parity: with
    frozen block-time estimates (estimate_beta=0 after calibration) the
    scheduling layer is deterministic, so max_batch 1 and 8 take the
    identical detect -> explore -> commit walk."""
    cfg, params, queries = setup
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        estimate_beta=0.3, device="cpu")
    eng.executor.warmup(1, 64)
    probe = eng.serve(queries[:8], lambda q: [1.0] * 4)
    service = float(probe.service_latencies[3:].mean())
    eng.estimate_beta = 0.0        # freeze: deterministic scheduling
    wl = dict(burst_rate=8.0 / service, base_rate=0.3 / service,
              mean_burst=60 * service, mean_gap=15 * service, seed=0)

    def schedule(q):
        slow = [1.0] * 4
        if 12 <= q < 30:
            slow[1] = 3.0
        return slow

    runs = {}
    for mb in (1, 8):
        eng.reset_policy()
        runs[mb] = eng.serve(queries, schedule, workload="bursty",
                             workload_kwargs=wl, max_batch=mb)
    a, b = runs[1], runs[8]
    assert b.num_rebalances == a.num_rebalances
    assert b.total_trials == a.total_trials
    assert b.mitigation_lengths == a.mitigation_lengths
    assert b.configs_trace == a.configs_trace
    assert np.array_equal(b.serial_mask, a.serial_mask)
    assert a.queue_delays.max() > 0 and b.queue_delays.max() > 0
    assert np.allclose(b.latencies, b.queue_delays + b.service_latencies)
    assert np.allclose(a.latencies, a.queue_delays + a.service_latencies)


def test_engine_open_loop_bursty_reports_queueing(setup):
    """tests/test_serving.py::test_engine_open_loop_bursty_reports_queueing:
    queueing delay is accounted separately from measured service."""
    cfg, params, queries = setup
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="none",
                        device="cpu")
    eng.executor.warmup(1, 64)
    probe = eng.serve(queries[:2], lambda q: [1.0] * 4)
    service = float(probe.service_latencies.mean())
    m = eng.serve(queries[:20], lambda q: [1.0] * 4, workload="bursty",
                  workload_kwargs=dict(burst_rate=4.0 / service,
                                       base_rate=0.0,
                                       mean_burst=40 * service,
                                       mean_gap=5 * service, seed=0))
    assert m.workload == "bursty"
    assert np.allclose(m.latencies, m.queue_delays + m.service_latencies)
    assert m.queue_delays.max() > 0           # the burst outran the pipe
    assert np.all(m.service_latencies > 0)
    assert m.offered_load > 0 and np.isfinite(m.achieved_load)


SUMMARY_OPTIONS = {
    "closed": dict(),
    "bursty_max_batch": dict(workload="bursty", max_batch=4,
                             workload_kwargs=dict(burst_rate=400.0,
                                                  base_rate=20.0, seed=0)),
    "continuous": dict(_LIVE_KW),
    "drain_streaming": dict(_LIVE_KW, batching="drain",
                            trace_mode="streaming"),
}


@pytest.mark.parametrize("options", list(SUMMARY_OPTIONS))
def test_summary_keys_equal_the_jax_engines(options, live_setup):
    """The port's summary() has exactly the JAX engine's keys, in the
    same order, for the same serve options."""
    jcfg, jparams, cfg, params, tokens = live_setup
    kw = SUMMARY_OPTIONS[options]
    tokens = tokens[:8]
    port = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                         device="cpu").serve(_port_queries(tokens),
                                             _live_schedule, **kw)
    ref = JaxEngine(jcfg, jparams, num_eps=4, scheduler="odin",
                    alpha=3).serve([jnp.asarray(t) for t in tokens],
                                   _live_schedule, **kw)
    assert list(port.summary()) == list(ref.summary())
    assert type(port).__name__ == type(ref).__name__


def _jax_dispatch(jcfg, jparams, padded, members, joiner, config, s):
    """The JAX executor's arithmetic of one continuous dispatch, as its
    _LiveDispatchBuilder does it: the members embedded and run through
    stages [0, s); the joiner embedded and caught up through the blocks
    of those stages in one fused stage_fn call; the rows spliced,
    re-padded to a power of two and run through the remaining stages.
    Returns (last hidden states, logits) of the real rows."""
    ex = JaxExecutor(jcfg, jparams)
    bounds = ex._device_bounds(config)
    toks = jnp.concatenate([jnp.asarray(padded[q]) for q in members])
    rows = toks.shape[0]
    toks = jnp.concatenate([toks, jnp.zeros(
        (next_pow2(rows) - rows, toks.shape[1]), toks.dtype)])
    x, pos = ex.embed_tokens(toks)
    x, _ = ex.run_stages(x, pos, config, 0, s, bounds=bounds)
    h, hpos = ex.embed_tokens(jnp.asarray(padded[joiner]))
    h = ex._stage_fn(ex.params, h, hpos, bounds[0][0], bounds[s - 1][1])
    x = jnp.concatenate([x[:rows], h[:1]])
    n = x.shape[0]
    x = jnp.concatenate([x, jnp.zeros((next_pow2(n) - n,) + x.shape[1:],
                                      x.dtype)])
    pos = jnp.broadcast_to(jnp.arange(x.shape[1], dtype=jnp.int32),
                           x.shape[:2])
    x, _ = ex.run_stages(x, pos, config, s, len(config), bounds=bounds)
    return np.asarray(x[:n]), np.asarray(ex.head(x)[:n])


@pytest.mark.parametrize("which", ["qwen2-0.5b", "mamba2-370m"])
def test_dispatch_with_a_join_matches_jax(which, live_setup, mamba_setup):
    """One continuous dispatch with a join, taken out of the port's
    _LiveDispatchBuilder: two members padded to the 64-token bucket edge,
    a joiner spliced in after stage 1.  Its last hidden states and logits
    equal the JAX executor's on every member's real rows and positions
    (the executor tolerance of tests/test_pipeline.py), and each row's
    logits on its real positions equal the query's logits alone."""
    jcfg, jparams, cfg, params, _ = (live_setup if which == "qwen2-0.5b"
                                     else mamba_setup)
    rng = np.random.default_rng(7)
    lengths = [40, 64, 50]
    tokens = [rng.integers(0, cfg.vocab_size, (1, n)) for n in lengths]
    config = [2, 2, 2, 2] if cfg.num_blocks == 8 else [1, 1]
    s = 1                                 # the join comes after stage s

    eng = ServingEngine(cfg, params, num_eps=len(config), device="cpu")
    live = eng.query_executor(_port_queries(tokens), lambda q: None)
    former = resolve_batching("continuous", max_batch=4,
                              buckets="pow2:32:64", seq=64)
    live.configure_batching(former, np.array(lengths),
                            former.padded_lengths(np.array(lengths)))
    live._slow = None
    builder = live.begin_dispatch(0, RuntimeStep(config, serial=False))
    builder.add(0)
    builder.add(1)
    for _ in range(s):
        assert builder.next_boundary() is not None
    builder.join(2)
    rec = builder.finish()
    assert rec.start_offsets[0] == rec.start_offsets[1] == 0.0
    assert 0 < rec.start_offsets[2] < rec.drain
    assert rec.padded_tokens == 4 * 64 and rec.actual_tokens == sum(lengths)
    assert tuple(builder._x.shape[:2]) == (4, 64)
    with torch.inference_mode():
        hidden = builder._x[:3].numpy()
        logits = eng.executor.head(builder._x)[:3].numpy()

    padded = [np.pad(t, ((0, 0), (0, 64 - t.shape[1]))) for t in tokens]
    want_h, want_l = _jax_dispatch(jcfg, jparams, padded, [0, 1], 2,
                                   config, s)
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(hidden[i, :n], want_h[i, :n],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(logits[i, :n], want_l[i, :n],
                                   atol=1e-4, rtol=1e-4)
        alone, _ = eng.executor.run_query(torch.from_numpy(tokens[i]),
                                          config)
        np.testing.assert_allclose(logits[i, :n], alone[0].numpy(),
                                   atol=1e-4, rtol=1e-4)


def _env():
    return {"PYTHONPATH": str(ROOT / "src"),
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": os.environ.get("HOME", "/tmp")}


CLI_BATCHED = ["-m", "repro_torch.launch.serve", "--arch", "qwen2-0.5b",
               "--workload", "bursty", "--batching", "continuous",
               "--max-batch", "4", "--buckets", "pow2:32:64", "--lengths",
               "bimodal", "--seq", "64", "--queries", "24"]


def test_serve_cli_bursty_continuous_on_cpu(tmp_path):
    export = tmp_path / "metrics.prom"
    r = subprocess.run(
        [sys.executable, *CLI_BATCHED, "--device", "cpu", "--json"],
        capture_output=True, text=True, env=_env(), cwd=str(ROOT),
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    s = json.loads(r.stdout.strip().splitlines()[-1])
    assert s["mean_batch_occupancy"] >= 1.0
    assert s["mean_queue_delay_s"] >= 0.0
    assert np.isfinite(s["achieved_load_qps"])
    r = subprocess.run(
        [sys.executable, *CLI_BATCHED, "--device", "cpu", "--trace-mode",
         "streaming", "--metrics-export", str(export)],
        capture_output=True, text=True, env=_env(), cwd=str(ROOT),
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "mean_batch_occupancy" in r.stdout
    assert export.read_text().strip()


def test_serve_cli_batched_without_cpu_flag_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run([sys.executable, *CLI_BATCHED], capture_output=True,
                       text=True, env=_env(), cwd=str(ROOT), timeout=120)
    assert r.returncode != 0
    assert "cuda" in r.stderr.lower()
    assert "mean_batch_occupancy" not in r.stdout
