"""The port's copy of the control plane against the original: the same
sequence of measured time sources must drive both runtimes through the
same detect -> explore -> commit walk, step for step."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.lls as jax_lls  # noqa: E402
import repro.core.odin as jax_odin  # noqa: E402
import repro.core.pipeline_state as jax_ps  # noqa: E402
from repro.pipeline import MeasuredTimeSource as JaxSource  # noqa: E402
from repro.schedulers import policies as jax_policies  # noqa: E402
from repro.schedulers.runtime import RebalanceRuntime as JaxRuntime  # noqa: E402
from repro_torch.core import lls, odin  # noqa: E402
from repro_torch.core import pipeline_state as ps  # noqa: E402
from repro_torch.pipeline import MeasuredTimeSource  # noqa: E402
from repro_torch.schedulers import policies  # noqa: E402
from repro_torch.schedulers.runtime import RebalanceRuntime  # noqa: E402


def _episodes(num_eps: int, seed: int, n: int):
    """Per-query slowdown vectors: two interference episodes, each on a
    random EP at a Table-1-like factor."""
    rng = np.random.default_rng(seed)
    slow = np.ones((n, num_eps))
    for start in (n // 6, n // 2):
        ep = int(rng.integers(num_eps))
        slow[start:start + n // 4, ep] = rng.choice([1.18, 1.95, 3.2])
    return slow


def _policy(pkg, name, mode):
    if name == "odin":
        return pkg.OdinPolicy(alpha=3, detector=mode)
    return pkg.LLSPolicy(detector=mode)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["rel", "ema"])
@pytest.mark.parametrize("name", ["odin", "lls"])
def test_runtime_walk_is_identical(name, mode, seed):
    num_eps, blocks, n = 4, 16, 120
    rng = np.random.default_rng(100 + seed)
    base = rng.uniform(0.5, 1.5, blocks)
    slow = _episodes(num_eps, seed, n)
    config = ps.balanced_config(blocks, num_eps)
    assert config == jax_ps.balanced_config(blocks, num_eps)
    port = RebalanceRuntime(_policy(policies, name, mode), config)
    ref = JaxRuntime(_policy(jax_policies, name, mode), config)
    port.arm(MeasuredTimeSource(base, slow[0]))
    ref.arm(JaxSource(base, slow[0]))
    for q in range(1, n):
        # measured block times jitter query to query
        bt = base * rng.uniform(0.97, 1.03, blocks)
        a = port.poll(MeasuredTimeSource(bt, slow[q]))
        b = ref.poll(JaxSource(bt, slow[q]))
        assert (a.config, a.serial, a.committed) == \
            (b.config, b.serial, b.committed), q
        assert port.config == ref.config
    assert port.num_rebalances == ref.num_rebalances >= 1
    assert port.total_trials == ref.total_trials
    assert port.mitigation_lengths == ref.mitigation_lengths


@pytest.mark.parametrize("seed", range(4))
def test_explorers_to_completion_match(seed):
    rng = np.random.default_rng(seed)
    bt = rng.uniform(0.2, 2.0, 24)
    s = np.ones(6)
    s[rng.integers(6)] = rng.uniform(1.5, 3.5)
    config = ps.balanced_config(24, 6)
    a = odin.odin_rebalance(config, 4, MeasuredTimeSource(bt, s))
    b = jax_odin.odin_rebalance(config, 4, JaxSource(bt, s))
    assert (a.config, a.throughput) == (b.config, b.throughput)
    assert [(t.config, t.throughput, t.improved) for t in a.trials] == \
        [(t.config, t.throughput, t.improved) for t in b.trials]
    c = lls.lls_rebalance(config, MeasuredTimeSource(bt, s))
    d = jax_lls.lls_rebalance(config, JaxSource(bt, s))
    assert (c.config, c.throughput, c.num_trials) == \
        (d.config, d.throughput, d.num_trials)


def test_pipeline_state_primitives_match():
    rng = np.random.default_rng(7)
    for _ in range(5):
        t = rng.uniform(0.0, 2.0, 5)
        t[rng.integers(5)] = 0.0
        assert ps.throughput(t) == jax_ps.throughput(t)
        np.testing.assert_array_equal(ps.waiting_times(t),
                                      jax_ps.waiting_times(t))
        np.testing.assert_array_equal(ps.utilization(t),
                                      jax_ps.utilization(t))
        assert ps.pipelined_latency(t) == jax_ps.pipelined_latency(t)
        assert ps.serial_latency(t) == jax_ps.serial_latency(t)
        assert ps.boundaries([2, 0, 3]) == jax_ps.boundaries([2, 0, 3])


def test_static_policy_never_rebalances():
    rt = RebalanceRuntime(policies.make_scheduler("none"), [2, 2])
    for q in range(10):
        step = rt.poll(MeasuredTimeSource(np.ones(4), [1.0, 1.0 + q]))
        assert step.config == [2, 2] and not step.serial
    assert rt.num_rebalances == 0
    with pytest.raises(ValueError, match="unknown scheduler"):
        policies.make_scheduler("oracle")
