"""The port's live fleet on the CPU at smoke width, against the JAX
package's: ``serve_cluster`` of port engines serves every admitted query
exactly once and never runs a shed one, and its summary has the JAX
fleet's keys; one engine under a query-indexed fault plan fails and
retries the same queries as the JAX engine and a deterministic stand-in;
an error that is not a transient query error ends the run; and the serve
CLI's fleet options give the JAX CLI's summary keys and errors.  No test
asserts on a measured latency."""
import contextlib
import dataclasses
import io
import json
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.launch.serve as jax_cli  # noqa: E402
import repro_torch.launch.serve as port_cli  # noqa: E402
from repro.cluster import serve_cluster as jax_serve_cluster  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.cluster import serve_cluster  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from test_torch_workloads import JAX, PORT, FakeExecutor  # noqa: E402

LAYERS = 4
SEQ = 32
N = 16
FAULT_PLAN = "crash@5+3,flaky@0+1000:p=0.2"
#: Per-tier keys a tiered fleet summary carries (chip_smoke.py's phase
#: 12 lists the same for the card's runs).
TIER_KEYS = ("num", "shed", "p50_latency_s", "p99_latency_s",
             "deadline_attainment", "downgraded")


@pytest.fixture(scope="module")
def models():
    """qwen2-0.5b at smoke width, LAYERS blocks, the JAX weights carried
    into the port."""
    jcfg = dataclasses.replace(jax_smoke("qwen2-0.5b"), num_layers=LAYERS)
    jparams = JaxModel(jcfg).init_params(jax.random.PRNGKey(0), jnp.float32)
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              num_layers=LAYERS)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(0)
    tokens = [rng.integers(0, cfg.vocab_size, (1, SEQ)) for _ in range(N)]
    return jcfg, jparams, cfg, params, tokens


def _port_engines(models, n, **kw):
    _, _, cfg, params, _ = models
    first = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                          device="cpu", **kw)
    first.executor.warmup(1, SEQ)
    return [first] + [ServingEngine(cfg, params, num_eps=4, scheduler="odin",
                                    alpha=3, device="cpu",
                                    executor=first.executor, **kw)
                      for _ in range(n - 1)]


def _jax_engines(models, n):
    jcfg, jparams, _, _, _ = models
    first = JaxEngine(jcfg, jparams, num_eps=4, scheduler="odin", alpha=3)
    first.executor.warmup(1, SEQ)
    return [first] + [JaxEngine(jcfg, jparams, num_eps=4, scheduler="odin",
                                alpha=3, executor=first.executor)
                      for _ in range(n - 1)]


def _schedule(q):
    return [1.0, 3.0, 1.0, 1.0] if 4 <= q < 10 else [1.0] * 4


class _CountRuns:
    """Counts the queries an executor runs (``run_query`` calls)."""

    def __init__(self, executor):
        self.executor, self.runs = executor, 0
        self._orig = executor.run_query

        def run_query(*a, **k):
            self.runs += 1
            return self._orig(*a, **k)

        executor.run_query = run_query

    def close(self):
        del self.executor.run_query


POISSON = dict(workload="poisson", workload_kwargs=dict(rate=2000.0, seed=2))


@pytest.mark.parametrize("router", ["round_robin", "odin_aware",
                                    "least_outstanding"])
def test_serve_cluster_serves_every_query_once(models, router):
    engines = _port_engines(models, 3)
    queries = [torch.from_numpy(t) for t in models[4]]
    count = _CountRuns(engines[0].executor)
    try:
        ct = serve_cluster(engines, queries, _schedule, router=router,
                           **POISSON)
    finally:
        count.close()
    assert ct.num_queries == N and ct.num_shed == 0
    assert sorted(ct.assignments) == sorted(np.repeat(
        np.arange(3), ct.replica_counts))
    assert int(ct.replica_counts.sum()) == N == count.runs
    assert all(len(t.latencies) == c
               for t, c in zip(ct.replicas, ct.replica_counts))
    # Each replica's local slots are filled once, in order.
    for r in range(3):
        assert sorted(ct.local_indices[ct.assignments == r]) == \
            list(range(int(ct.replica_counts[r])))


@pytest.mark.parametrize("admission,kwargs", [
    ("slo_shed", dict(slo=1e-4)), ("queue_cap", dict(cap=1))])
def test_shed_queries_never_reach_an_executor(models, admission, kwargs):
    engines = _port_engines(models, 2)
    queries = [torch.from_numpy(t) for t in models[4]]
    count = _CountRuns(engines[0].executor)
    try:
        ct = serve_cluster(engines, queries, _schedule, router="odin_aware",
                           admission=admission, admission_kwargs=kwargs,
                           **POISSON)
    finally:
        count.close()
    assert ct.num_shed > 0
    assert ct.num_admitted + ct.num_shed == N
    assert count.runs == ct.num_admitted


FLEET_OPTIONS = {
    "plain": dict(router="round_robin"),
    "control": dict(router="downgrade", pools=["default", "small"],
                    tiers="interactive,best_effort",
                    admission="value_shed", autoscaler="load_profile"),
    "faults": dict(router="edf", tiers="interactive,best_effort",
                   faults="crash@0.001+0.002:r=0,flaky@0+100:p=0.2",
                   retries=3, hedge_after=0.001),
    "streaming": dict(router="odin_aware", trace_mode="streaming"),
}


@pytest.mark.parametrize("options", list(FLEET_OPTIONS))
def test_serve_cluster_summary_keys_equal_jax(models, options):
    kw = dict(FLEET_OPTIONS[options], **POISSON)
    port = serve_cluster(_port_engines(models, 2),
                         [torch.from_numpy(t) for t in models[4]],
                         _schedule, **kw)
    ref = jax_serve_cluster(_jax_engines(models, 2),
                            [jnp.asarray(t) for t in models[4]],
                            _schedule, **kw)
    assert list(port.summary()) == list(ref.summary())
    assert type(port).__name__ == type(ref).__name__
    if "tiers" in kw:
        for name in ("interactive", "best_effort"):
            keys = [f"tier_{name}_{k}" for k in TIER_KEYS]
            if kw["router"] != "downgrade":
                keys = keys[:-1]
            assert all(k in port.summary() for k in keys)


class _Served:
    """Wraps a query executor and records the queries whose execution
    completed."""

    def __init__(self, inner):
        self.inner, self.done = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute(self, q, step):
        rec = self.inner.execute(q, step)
        self.done.append(int(q))
        return rec

    def execute_many(self, q0, steps):
        rec = self.inner.execute_many(q0, steps)
        self.done.extend(range(q0, q0 + len(steps)))
        return rec


def _served_by(engine):
    """Make ``engine`` wrap its query executors in ``_Served``."""
    made = []
    orig = engine.query_executor

    def query_executor(*a, **k):
        made.append(_Served(orig(*a, **k)))
        return made[-1]

    engine.query_executor = query_executor
    return made


def _outcome(trace, served, n):
    failed = sorted(set(range(n)) - set(served.done))
    return trace.num_failed, trace.num_retried, failed


def test_query_indexed_faults_equal_jax_engine_and_stand_in(models):
    """Query-indexed outcomes depend on (seed, query, attempt) only: the
    port engine, the JAX engine and a deterministic stand-in over either
    package's run loop fail and retry the same queries."""
    jcfg, jparams, cfg, params, tokens = models
    kw = dict(faults=FAULT_PLAN, retries=2)
    port = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                         device="cpu")
    made = _served_by(port)
    a = _outcome(port.serve([torch.from_numpy(t) for t in tokens],
                            _schedule, **kw), made[0], N)
    ref = JaxEngine(jcfg, jparams, num_eps=4, scheduler="odin", alpha=3)
    made = _served_by(ref)
    b = _outcome(ref.serve([jnp.asarray(t) for t in tokens], _schedule,
                           **kw), made[0], N)
    stand_in = []
    for pkg in (PORT, JAX):
        runtime = pkg.Runtime(pkg.policy("odin"), [1, 1, 1, 1])
        fx = _Served(FakeExecutor(pkg, runtime, np.full(N, SEQ), _schedule,
                                  blocks=LAYERS))
        trace = pkg.wl.run_pipeline(fx, runtime, N, **kw)
        stand_in.append(_outcome(trace, fx, N))
    assert a == b == stand_in[0] == stand_in[1]
    num_failed, num_retried, failed = a
    assert {5, 6, 7} <= set(failed) and num_failed == len(failed)
    assert num_retried >= 2 * 3


class _CudaFailure:
    """An executor whose third ``run_query`` raises what a failed CUDA
    launch raises: a RuntimeError."""

    def __init__(self, executor):
        self.executor, self.calls = executor, 0
        self._orig = executor.run_query

        def run_query(*a, **k):
            self.calls += 1
            if self.calls == 3:
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")
            return self._orig(*a, **k)

        executor.run_query = run_query

    def close(self):
        del self.executor.run_query


@pytest.mark.parametrize("where", ["engine", "fleet"])
def test_runtime_error_ends_a_run_with_retries(models, where):
    """Only TransientQueryError is retried: a RuntimeError (a CUDA error,
    a kernel that fails to build or launch) propagates out of the run
    and is never counted as a failed query."""
    engines = _port_engines(models, 2)
    queries = [torch.from_numpy(t) for t in models[4]]
    broken = _CudaFailure(engines[0].executor)
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            if where == "engine":
                engines[0].serve(queries, _schedule, faults=FAULT_PLAN,
                                 retries=3, **POISSON)
            else:
                serve_cluster(engines, queries, _schedule,
                              router="round_robin", retries=3,
                              hedge_after=0.001,
                              faults="flaky@0+100:p=0.2", **POISSON)
    finally:
        broken.close()
    assert broken.calls == 3


def test_stand_in_runtime_error_propagates_through_both_loops():
    """The same in either package's run loop, with faults armed."""
    for pkg in (PORT, JAX):
        runtime = pkg.Runtime(pkg.policy("odin"), [3, 3, 3, 3])
        fx = FakeExecutor(pkg, runtime, np.full(N, SEQ), _schedule)
        orig, calls = fx.execute, []

        def execute(q, step, orig=orig, calls=calls):
            calls.append(q)
            if len(calls) == 3:
                raise RuntimeError("CUDA error: launch failure")
            return orig(q, step)

        fx.execute = execute
        with pytest.raises(RuntimeError, match="launch failure"):
            pkg.wl.run_pipeline(fx, runtime, N, faults=FAULT_PLAN,
                                retries=3)
        assert len(calls) == 3


# ---------------------------------------------------------------------------
# the serve CLI's fleet options against the JAX CLI's

def _cli(module, argv, device):
    """Run ``module.main()`` with ``argv``; (exit code, stdout, stderr)."""
    args = ["serve", *argv] + (["--device", "cpu"] if device else [])
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv
    sys.argv = args
    code = 0
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            module.main()
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    finally:
        sys.argv = saved
    return code, out.getvalue(), err.getvalue()


SMOKE = ["--blocks", "2", "--seq", "32", "--queries", "8", "--json"]
CLI_RUNS = {
    "replicas": ["--replicas", "2", "--router", "odin_aware"],
    "configs_tiers": ["--configs", "qwen3-4b,qwen2-0.5b", "--tiers",
                      "interactive,best_effort", "--router", "downgrade"],
    "faults": ["--faults", "crash@3+2,flaky@0+100:p=0.2", "--retries", "2",
               "--workload", "poisson"],
}


@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_cli_fleet_summary_keys_equal_jax(run):
    argv = CLI_RUNS[run] + SMOKE
    code, out, err = _cli(port_cli, argv, device=True)
    assert code == 0, err[-2000:]
    port = json.loads(out.strip().splitlines()[-1])
    code, out, err = _cli(jax_cli, argv, device=False)
    assert code == 0, err[-2000:]
    ref = json.loads(out.strip().splitlines()[-1])
    assert list(port) == list(ref)
    if run == "faults":
        assert port["num_failed"] + port["num_retried"] > 0


CLI_ERRORS = {
    "unknown_config": ["--configs", "qwen3-4b,nope"],
    "configs_vs_replicas": ["--configs", "qwen3-4b,qwen2-0.5b",
                            "--replicas", "3"],
    "unknown_tier": ["--tiers", "gold"],
    "slo_missing": ["--admission", "slo_shed"],
    "unknown_admission": ["--admission", "bogus"],
    "no_replicas": ["--replicas", "0"],
    "hedge_alone": ["--hedge-after", "1.0"],
    "fleet_batching": ["--replicas", "2", "--batching", "drain"],
    "fleet_export": ["--replicas", "2", "--trace-mode", "streaming",
                     "--metrics-export", "m.json"],
    "fleet_faults_closed": ["--replicas", "2", "--faults", "crash@1+2"],
    "router_alone": ["--router", "odin_aware"],
}


@pytest.mark.parametrize("case", list(CLI_ERRORS))
def test_cli_errors_equal_jax(case):
    argv = CLI_ERRORS[case] + SMOKE
    port = _cli(port_cli, argv, device=True)
    ref = _cli(jax_cli, argv, device=False)
    assert port[0] == ref[0] == 2
    assert port[2].strip().splitlines()[-1] == \
        ref[2].strip().splitlines()[-1]
