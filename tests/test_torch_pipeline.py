"""The port's pipeline executor against the JAX package's monolithic
forward (mirrors tests/test_pipeline.py on the same weights)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.pipeline import (  # noqa: E402
    LocalPipelineExecutor as JaxLocalPipelineExecutor,
    MeasuredTimeSource as JaxMeasuredTimeSource,
    stage_bounds as jax_stage_bounds,
)
from repro.core.mesh import MeshSpec as JaxMeshSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.mesh import MeshSpec  # noqa: E402
from repro_torch.pipeline import (  # noqa: E402
    LocalPipelineExecutor,
    MeasuredTimeSource,
    next_pow2,
    stage_bounds,
)
from repro_torch.util.errors import MixedSequenceLengthError  # noqa: E402

CONFIGS = ([2, 2, 2], [1, 3, 2], [6], [3, 0, 3], [1, 1, 1, 1, 1, 1])


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_smoke("qwen3-8b"), num_layers=6)
    model = JaxModel(jcfg)
    jp = model.init_params(jax.random.PRNGKey(0), jnp.float32)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (1, 32))
    ref_logits, _ = model.forward(jp, tokens=jnp.asarray(tokens))
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), num_layers=6)
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ex = LocalPipelineExecutor(cfg, params, device="cpu")
    return cfg, ex, tokens, np.asarray(ref_logits)


@pytest.fixture(scope="module")
def mamba_setup():
    """mamba2-370m smoke at 4 blocks: the executor over Mamba2 blocks."""
    jcfg = dataclasses.replace(jax_smoke("mamba2-370m"), num_layers=4)
    model = JaxModel(jcfg)
    jp = model.init_params(jax.random.PRNGKey(2), jnp.float32)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (1, 40))
    ref_logits, _ = model.forward(jp, tokens=jnp.asarray(tokens))
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), num_layers=4)
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ex = LocalPipelineExecutor(cfg, params, device="cpu")
    return ex, tokens, np.asarray(ref_logits)


@pytest.mark.parametrize("config", ([2, 2], [1, 3], [4], [0, 4],
                                    [1, 1, 1, 1]), ids=str)
def test_executor_matches_jax_model_on_mamba2(mamba_setup, config):
    ex, tokens, ref = mamba_setup
    logits, times = ex.run_query(torch.from_numpy(tokens), config)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)
    assert times.shape == (len(config),)


@pytest.mark.parametrize("arch,blocks", [("deepseek-moe-16b", 2),
                                         ("jamba-1.5-large-398b", 2)])
def test_executor_matches_jax_run_query_on_moe(arch, blocks):
    """Stages split [1, 1] over MoE blocks (jamba's smoke config is one
    block: two here) against the JAX executor's run_query on the same
    weights; the router statistics the blocks return are dropped, as the
    JAX stage function drops them."""
    jcfg = jax_smoke(arch)
    jcfg = dataclasses.replace(
        jcfg, num_layers=blocks * len(jcfg.layer_pattern))
    jp = JaxModel(jcfg).init_params(jax.random.PRNGKey(3), jnp.float32)
    tokens = np.random.default_rng(6).integers(0, jcfg.vocab_size, (1, 48))
    want, _ = JaxLocalPipelineExecutor(jcfg, jp).run_query(
        jnp.asarray(tokens), [1, 1])
    cfg = dataclasses.replace(get_smoke_config(arch),
                              num_layers=jcfg.num_layers)
    ex = LocalPipelineExecutor(
        cfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
        device="cpu")
    got, times = ex.run_query(torch.from_numpy(tokens), [1, 1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert times.shape == (2,) and np.all(times > 0)
    whole, _ = ex.run_query(torch.from_numpy(tokens), [2])
    np.testing.assert_array_equal(whole.numpy(), got.numpy())


def test_stage_bounds_and_next_pow2_match_jax():
    for config in ([2, 0, 3], [6], [1, 1, 1, 1, 1, 1], [0, 4, 0]):
        assert stage_bounds(config) == jax_stage_bounds(config)
    assert [next_pow2(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]


@pytest.mark.parametrize("config", CONFIGS, ids=str)
def test_executor_matches_jax_model(setup, config):
    """Pipeline-partitioned execution == the JAX monolithic forward."""
    cfg, ex, tokens, ref = setup
    logits, times = ex.run_query(torch.from_numpy(tokens), config)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-4, rtol=1e-4)
    assert times.shape == (len(config),)
    assert np.all(times[np.asarray(config) > 0] > 0)
    assert np.all(times[np.asarray(config) == 0] >= 0)


def test_run_stages_in_pieces_equals_run_query(setup):
    cfg, ex, tokens, ref = setup
    x, pos = ex.embed_tokens(torch.from_numpy(tokens))
    x, t1 = ex.run_stages(x, pos, [2, 2, 2], 0, 1)
    x, t2 = ex.run_stages(x, pos, [2, 2, 2], 1, 3)
    assert t1.shape == (1,) and t2.shape == (2,)
    np.testing.assert_allclose(ex.head(x).numpy(), ref, atol=1e-4, rtol=1e-4)


def test_slowdown_stretches_measured_stage_time(setup):
    cfg, ex, tokens, _ = setup
    # Each side is the least of three runs: a run stretched by a busy host
    # would otherwise stand in for it.
    def least(slowdowns):
        return min(ex.run_query(torch.from_numpy(tokens), [3, 3],
                                slowdowns=slowdowns)[1][1] for _ in range(3))

    assert least([1.0, 20.0]) > 5 * least([1.0, 1.0])


@pytest.mark.parametrize("block_times,slow,config", [
    ([1.0, 2.0, 3.0, 4.0], [1.0, 2.0], [2, 2]),
    ([0.5, 1.5, 2.5, 3.5, 4.5], [1.0, 3.0, 1.5], [2, 0, 3]),
    ([1.0, 1.0, 2.0], [1.2, 1.0, 1.0], [0, 1, 2]),
])
def test_measured_time_source_matches_jax(block_times, slow, config):
    port = MeasuredTimeSource(np.array(block_times), np.array(slow))
    ref = JaxMeasuredTimeSource(np.array(block_times), np.array(slow))
    np.testing.assert_array_equal(port.stage_times(config),
                                  ref.stage_times(config))
    if config == [2, 2]:
        t = port.stage_times(config)
        assert t[0] == pytest.approx(3.0)
        assert t[1] == pytest.approx(14.0)   # (3+4) * 2.0
    # Mesh-sliced stages: the committed assignment, an explicit trial
    # one, per-layer collective costs and a contention factor.
    n = len(config)
    assign = [8 - (n - 1)] + [1] * (n - 1)
    trial = [1] * (n - 1) + [8 - (n - 1)]
    coll = np.linspace(0.1, 0.4, len(block_times))
    for kw in (dict(mesh=MeshSpec(8, coll_cost=0.3)),
               dict(mesh=MeshSpec(8), coll_times=coll, coll_factor=2.5),
               dict(mesh=MeshSpec(8, coll_costs=tuple(coll)),
                    assignment=assign, coll_factor=1.5)):
        jkw = dict(kw, mesh=JaxMeshSpec(**kw["mesh"].to_dict()))
        port = MeasuredTimeSource(np.array(block_times), np.array(slow),
                                  **kw)
        ref = JaxMeasuredTimeSource(np.array(block_times), np.array(slow),
                                    **jkw)
        np.testing.assert_array_equal(port.coll_times, ref.coll_times)
        for a in (None, trial):
            np.testing.assert_array_equal(port.stage_times(config, a),
                                          ref.stage_times(config, a))
            assert port.collective_frac(config, a) == \
                ref.collective_frac(config, a)
        if "assignment" in kw:     # one-argument calls price it
            np.testing.assert_array_equal(port.stage_times(config),
                                          port.stage_times(config, assign))


def test_run_batch_matches_stacked_run_query(setup):
    cfg, ex, _, _ = setup
    rng = np.random.default_rng(4)
    queries = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 24)))
               for _ in range(3)]
    singles = [ex.run_query(q, [2, 2, 2])[0] for q in queries]
    batched, st = ex.run_batch(queries, [2, 2, 2])
    assert batched.shape[0] == 3 and st.shape == (3,)
    np.testing.assert_allclose(batched.numpy(),
                               torch.cat(singles).numpy(),
                               rtol=2e-4, atol=2e-4)
    one, _ = ex.run_batch(queries[:1], [2, 2, 2])
    torch.testing.assert_close(one, singles[0])
    with pytest.raises(MixedSequenceLengthError, match="sequence length"):
        ex.run_batch([queries[0], queries[1][:, :16]], [2, 2, 2])
    with pytest.raises(ValueError, match="at least one"):
        ex.run_batch([], [2, 2, 2])


def test_warmup_and_block_times(setup):
    cfg, ex, tokens, _ = setup
    ex.ensure_warm(2, 16)
    assert (2, 16) in ex._warmed
    bt = ex.measure_block_times(torch.from_numpy(tokens), repeats=2)
    assert bt.shape == (cfg.num_blocks,) and np.all(bt > 0)
