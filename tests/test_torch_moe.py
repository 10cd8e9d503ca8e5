"""The port's mixture-of-experts FFN against the JAX package's, on the same
weights (through ``params_from_jax``) and the same inputs."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import MoEConfig  # noqa: E402
from repro_torch.convert import FP32_LEAVES, params_from_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402

# tests/test_kernels.py's fp32 tolerance order: the router runs in fp32 in
# both packages.
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
MOE_ARCHS = ["deepseek-moe-16b", "mixtral-8x22b"]


def _port_moe(m):
    """The JAX package's MoEConfig as the port's (the same fields)."""
    return MoEConfig(**dataclasses.asdict(m))


def _setup(arch, capacity_factor=None, seed=0):
    cfg = jax_smoke(arch)
    m = cfg.moe
    if capacity_factor is not None:
        m = dataclasses.replace(m, capacity_factor=capacity_factor)
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), cfg.d_model, m,
                          jnp.float32)
    port = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, m, jp, port


@pytest.mark.parametrize("E,K,cf", [(4, 2, 1.25), (64, 6, 1.25), (8, 2, 1.25),
                                    (16, 2, 1.25), (4, 2, 0.5), (4, 2, 2.0),
                                    (64, 6, 64 / 6)])
def test_capacity_per_group_matches_jax(E, K, cf):
    m = MoEConfig(num_experts=E, num_experts_per_tok=K, d_expert=8,
                  capacity_factor=cf)
    for tokens in (1, 2, 7, 40, 64, 66, 512, 1000, 4096):
        assert moe.capacity_per_group(tokens, m) == \
            jax_moe.capacity_per_group(tokens, m)
        c = moe.capacity_per_group(tokens, m)
        assert c >= 4 and c % 4 == 0


def test_group_tokens_matches_jax():
    for B in (1, 2, 3, 8):
        for S in (1, 2, 40, 64, 66, 256, 1000, 1024, 1025, 4608):
            for preferred in (512, 64):
                got = moe._group_tokens(B * S, S, preferred)
                assert got == jax_moe._group_tokens(B * S, S, preferred)
                assert (B * S) % got == 0
    # A length that is not a power of two makes groups that cross rows.
    assert moe._group_tokens(8 * 1000, 1000, 512) == 64
    assert moe._group_tokens(8 * 1024, 1024, 512) == 512


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_group_matches_jax(arch):
    """One group's dispatch, combine and statistics, exactly as JAX's
    (the 0/1 and gate entries are products of exact values)."""
    cfg, m, jp, port = _setup(arch, capacity_factor=0.5)
    T = 64
    C = moe.capacity_per_group(T, m)
    x = np.random.default_rng(4).standard_normal(
        (3, T, cfg.d_model)).astype(np.float32)
    got = moe._route_group(torch.from_numpy(x), port["router"], m, C)
    for g in range(3):
        want = jax_moe._route_group(jnp.asarray(x[g]), jp["router"], m, C)
        for name, a, b in zip(("dispatch", "combine", "f", "pbar", "zsum",
                               "dropped"), got, want):
            np.testing.assert_allclose(a[g].numpy(), np.asarray(b),
                                       err_msg=name, **MOE_TOL)
    assert float(got[-1].max()) > 0      # the low capacity drops pairs


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf,drops", [(None, None), (0.5, True),
                                      ("dropless", False)],
                         ids=["config", "drops", "dropless"])
def test_moe_forward_matches_jax(arch, cf, drops):
    """y and every RouterStats field, with the config's capacity, with a
    capacity low enough to drop pairs, and with one that drops none."""
    m0 = jax_smoke(arch).moe
    if cf == "dropless":
        cf = m0.num_experts / m0.num_experts_per_tok
    cfg, m, jp, port = _setup(arch, capacity_factor=cf, seed=1)
    x = np.random.default_rng(5).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    want_y, want = jax_moe.moe_forward(jp, m, jnp.asarray(x))
    got_y, got = moe.moe_forward(port, _port_moe(m), torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **MOE_TOL)
    for field in ("aux_loss", "router_z", "dropped_frac"):
        value = getattr(got, field)
        assert value.dtype == torch.float32 and value.dim() == 0
        np.testing.assert_allclose(float(value),
                                   float(getattr(want, field)),
                                   err_msg=field, **MOE_TOL)
    if drops is True:
        assert float(got.dropped_frac) > 0
    elif drops is False:
        assert float(got.dropped_frac) == 0


def test_moe_forward_decode_token_never_drops():
    """S = 1 routes each token in a group of its own: C = 4 >= top-k."""
    cfg, m, jp, port = _setup("deepseek-moe-16b", capacity_factor=0.5)
    x = np.random.default_rng(6).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32)
    got_y, got = moe.moe_forward(port, _port_moe(m), torch.from_numpy(x))
    want_y, _ = jax_moe.moe_forward(jp, m, jnp.asarray(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **MOE_TOL)
    assert float(got.dropped_frac) == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_mirrors_jax_and_keeps_router_fp32(arch):
    cfg = jax_smoke(arch)
    ref = jax.tree.map(np.asarray, jax_moe.init_moe(
        jax.random.PRNGKey(0), cfg.d_model, cfg.moe, jnp.bfloat16))
    got = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model,
                       _port_moe(cfg.moe), torch.bfloat16, "cpu")
    assert got.keys() == ref.keys()
    for name in ("router", "wi", "wg", "wo"):
        assert tuple(got[name].shape) == ref[name].shape
        assert (got[name].dtype == torch.float32) == (name == "router")
        assert (ref[name].dtype == np.float32) == (name == "router")
        std = float(ref[name].astype(np.float32).std())
        assert abs(float(got[name].float().std()) / std - 1) < 0.1, name
    assert "router" in FP32_LEAVES
    bridged = params_from_jax(ref, dtype=torch.bfloat16, device="cpu")
    assert bridged["router"].dtype == torch.float32
    np.testing.assert_array_equal(bridged["router"].numpy(), ref["router"])
