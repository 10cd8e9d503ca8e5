"""The port's copy of the control plane against the original: the same
sequence of measured time sources must drive both runtimes through the
same detect -> explore -> commit walk, step for step (every registered
policy, with and without a device mesh)."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core.lls as jax_lls  # noqa: E402
import repro.core.odin as jax_odin  # noqa: E402
import repro.core.pipeline_state as jax_ps  # noqa: E402
from repro.core.database import LayerDatabase as JaxDatabase  # noqa: E402
from repro.core.exhaustive import (  # noqa: E402
    optimal_partition as jax_optimal_partition,
    optimal_partition_mesh as jax_optimal_partition_mesh,
)
from repro.core.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from repro.pipeline import MeasuredTimeSource as JaxSource  # noqa: E402
from repro.schedulers import policies as jax_policies  # noqa: E402
from repro.schedulers.registry import (  # noqa: E402
    available_schedulers as jax_available_schedulers,
    make_scheduler as jax_make_scheduler,
)
from repro.schedulers.runtime import RebalanceRuntime as JaxRuntime  # noqa: E402
from repro_torch.core import lls, odin  # noqa: E402
from repro_torch.core import pipeline_state as ps  # noqa: E402
from repro_torch.core.database import LayerDatabase  # noqa: E402
from repro_torch.core.exhaustive import (  # noqa: E402
    optimal_partition,
    optimal_partition_mesh,
)
from repro_torch.core.mesh import MeshSpec, balanced_assignment  # noqa: E402
from repro_torch.pipeline import MeasuredTimeSource  # noqa: E402
from repro_torch.schedulers import policies  # noqa: E402
from repro_torch.schedulers.registry import (  # noqa: E402
    available_schedulers,
    make_scheduler,
)
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
    if name == "hybrid":
        return pkg.HybridPolicy(alpha=3, detector=mode)
    return pkg.LLSPolicy(detector=mode)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["rel", "ema"])
@pytest.mark.parametrize("name", ["odin", "lls", "hybrid"])
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
    rt = RebalanceRuntime(make_scheduler("none"), [2, 2])
    for q in range(10):
        step = rt.poll(MeasuredTimeSource(np.ones(4), [1.0, 1.0 + q]))
        assert step.config == [2, 2] and not step.serial
    assert rt.num_rebalances == 0
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_scheduler("no-such-policy")


def _walk(port, ref, sources, n, with_mesh=False):
    """Poll both runtimes with the same sources; every step must agree.
    Returns the number of steps that committed a phase."""
    commits = 0
    for q in range(1, n):
        a, b = port.poll(sources(q, False)), ref.poll(sources(q, True))
        assert (a.config, a.serial, a.committed, a.mesh) == \
            (b.config, b.serial, b.committed, b.mesh), q
        assert (port.config, port.mesh) == (ref.config, ref.mesh)
        commits += a.committed
        if with_mesh:
            assert sum(a.mesh) == 8 and min(a.mesh) >= 1
    assert port.num_rebalances == ref.num_rebalances
    assert port.total_trials == ref.total_trials
    assert port.mitigation_lengths == ref.mitigation_lengths
    assert port.num_mesh_resizes == ref.num_mesh_resizes
    return commits


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["rel", "ema"])
@pytest.mark.parametrize("name", ["odin", "lls", "hybrid"])
def test_mesh_runtime_walk_is_identical(name, mode, seed):
    """With a mesh armed ODIN walks (boundary, slice) moves
    (MeshOdinExplorer); LLS and hybrid move layers on the committed
    slices.  A collective-contention window rides on top of the compute
    slowdowns, as in the live engine's coll_factor_schedule."""
    num_eps, blocks, n = 4, 16, 120
    rng = np.random.default_rng(200 + seed)
    base = rng.uniform(0.5, 1.5, blocks)
    coll = rng.uniform(0.05, 0.4, blocks)
    slow = _episodes(num_eps, seed, n)
    cf = np.where((np.arange(n) >= n // 3) & (np.arange(n) < n // 2),
                  3.0, 1.0)
    jitter = rng.uniform(0.97, 1.03, (n, blocks))
    spec, jspec = (MeshSpec(devices=8, coll_costs=tuple(coll)),
                   JaxMeshSpec(devices=8, coll_costs=tuple(coll)))
    config = ps.balanced_config(blocks, num_eps)
    assign = balanced_assignment(8, num_eps)

    def sources(q, jax_side):
        cls, m = (JaxSource, jspec) if jax_side else (MeasuredTimeSource,
                                                      spec)
        return cls(base * jitter[q], slow[q], mesh=m, coll_factor=cf[q])

    port = RebalanceRuntime(_policy(policies, name, mode), config,
                            mesh=assign)
    ref = JaxRuntime(_policy(jax_policies, name, mode), config,
                     mesh=assign)
    port.arm(sources(0, False))
    ref.arm(sources(0, True))
    _walk(port, ref, sources, n, with_mesh=True)
    assert port.num_rebalances >= 1
    # Only ODIN's explorer moves devices; the others keep the slices.
    assert (port.num_mesh_resizes >= 1) == (name == "odin")


def _db_solver(pkg_db, pkg_opt):
    """The live oracle's solver: optimal_partition over a database with
    one column per EP (the block times times that EP's slowdown)."""
    def solver(config, source):
        table = source.block_times[:, None] * source.slowdowns[None, :]
        n = table.shape[1]
        db = pkg_db(table, [f"ep{e}" for e in range(n)])
        return pkg_opt(db, list(range(n)), n)[0]
    return solver


def _db_mesh_solver(pkg_db, pkg_opt_mesh):
    def solver(config, source):
        table = source.block_times[:, None] * source.slowdowns[None, :]
        n = table.shape[1]
        db = pkg_db(table, [f"ep{e}" for e in range(n)])
        cfg, assign, _ = pkg_opt_mesh(db, list(range(n)), n, source.mesh,
                                      coll_factor=source.coll_factor)
        return (list(cfg), list(assign))
    return solver


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mesh", [False, True])
def test_oracle_walk_is_identical(mesh, seed):
    """The oracle commits inside one poll: no serial query, no rebalance
    counted, the committed (config, slices) the DP optimum's."""
    num_eps, blocks, n = 4, 12, 60
    rng = np.random.default_rng(300 + seed)
    base = rng.uniform(0.5, 1.5, blocks)
    coll = rng.uniform(0.05, 0.4, blocks)
    slow = _episodes(num_eps, seed, n)
    jitter = rng.uniform(0.97, 1.03, (n, blocks))
    spec, jspec = (MeshSpec(devices=8, coll_costs=tuple(coll)),
                   JaxMeshSpec(devices=8, coll_costs=tuple(coll)))
    if mesh:
        port_pol = policies.OraclePolicy(
            _db_mesh_solver(LayerDatabase, optimal_partition_mesh))
        ref_pol = jax_policies.OraclePolicy(
            _db_mesh_solver(JaxDatabase, jax_optimal_partition_mesh))
    else:
        port_pol = policies.OraclePolicy(
            _db_solver(LayerDatabase, optimal_partition))
        ref_pol = jax_policies.OraclePolicy(
            _db_solver(JaxDatabase, jax_optimal_partition))

    def sources(q, jax_side):
        cls, m = (JaxSource, jspec) if jax_side else (MeasuredTimeSource,
                                                      spec)
        return cls(base * jitter[q], slow[q], mesh=m if mesh else None)

    config = ps.balanced_config(blocks, num_eps)
    assign = balanced_assignment(8, num_eps) if mesh else None
    port = RebalanceRuntime(port_pol, config, mesh=assign)
    ref = JaxRuntime(ref_pol, config, mesh=assign)
    assert _walk(port, ref, sources, n, with_mesh=mesh) >= 1
    assert port.total_trials == 0 and port.num_rebalances == 0


@pytest.mark.parametrize("seed", range(3))
def test_hybrid_and_mesh_explorers_to_completion_match(seed):
    rng = np.random.default_rng(400 + seed)
    bt = rng.uniform(0.2, 2.0, 24)
    coll = rng.uniform(0.05, 0.5, 24)
    s = np.ones(6)
    s[rng.integers(6)] = rng.uniform(1.5, 3.5)
    config = ps.balanced_config(24, 6)
    src = MeasuredTimeSource(bt, s)
    jsrc = JaxSource(bt, s)
    a = policies.HybridExplorer(config, 4)
    b = jax_policies.HybridExplorer(config, 4)
    while not b.done:
        assert a.step(src) == b.step(jsrc)
    assert a.done
    ra, rb = a.result(), b.result()
    assert (ra.config, ra.throughput) == (rb.config, rb.throughput)
    assert [(t.config, t.throughput, t.improved) for t in ra.trials] == \
        [(t.config, t.throughput, t.improved) for t in rb.trials]
    assign = [1, 1, 2, 2, 1, 1]
    msrc = MeasuredTimeSource(bt, s, mesh=MeshSpec(8, coll_costs=tuple(coll)),
                              assignment=assign)
    mjsrc = JaxSource(bt, s, mesh=JaxMeshSpec(8, coll_costs=tuple(coll)),
                      assignment=assign)
    c = odin.MeshOdinExplorer(config, 4, assign)
    d = jax_odin.MeshOdinExplorer(config, 4, assign)
    while not d.done:
        assert c.step(msrc) == d.step(mjsrc)
        assert c.A == d.A
    assert c.done
    rc, rd = c.result(), d.result()
    assert (rc.config, rc.throughput, rc.mesh) == \
        (rd.config, rd.throughput, rd.mesh)
    assert [(t.config, t.throughput, t.improved, t.mesh)
            for t in rc.trials] == \
        [(t.config, t.throughput, t.improved, t.mesh) for t in rd.trials]


def test_registry_matches_jax():
    """The registry names the JAX package's policies, and every policy
    declares the same fast-path contract (steady_detect_stable) in both
    detector modes."""
    assert available_schedulers() == jax_available_schedulers()
    for name in available_schedulers():
        for mode in ("rel", "ema"):
            kw = dict(alpha=3, detector=mode, solver=lambda c, s: list(c))
            a, b = make_scheduler(name, **kw), jax_make_scheduler(name, **kw)
            assert type(a).__name__ == type(b).__name__
            assert getattr(a, "steady_detect_stable", None) == \
                getattr(b, "steady_detect_stable", None), (name, mode)
    assert make_scheduler("odin", detector="rel").steady_detect_stable
    assert not make_scheduler("odin", detector="ema").steady_detect_stable


def test_oracle_requires_solver():
    with pytest.raises(TypeError):
        make_scheduler("oracle")


def test_core_exports_controller_aliases():
    import repro_torch.core as core
    from repro_torch.core import lls as core_lls, odin as core_odin
    assert core.OdinController is policies.OdinPolicy
    assert core.LLSController is policies.LLSPolicy
    assert core_odin.OdinController is policies.OdinPolicy
    assert core_lls.LLSController is policies.LLSPolicy
