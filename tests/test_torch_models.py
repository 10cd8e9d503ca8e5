"""The port's layers, attention and model against the JAX package's, on
the same weights (through ``params_from_jax``) and the same inputs."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import blocks as jax_blk  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import mamba2 as jax_mamba  # noqa: E402
from repro_torch.configs import ARCH_IDS, MoEConfig, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import mamba2 as mamba  # noqa: E402

# tests/test_pipeline.py's tolerance for fp32 logits.
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["qwen3-4b", "qwen3-8b", "qwen3-32b", "qwen2-0.5b", "mamba2-370m"]
# The MoE and embedding-input families.
FAMILIES = ["deepseek-moe-16b", "mixtral-8x22b", "jamba-1.5-large-398b",
            "llava-next-34b", "hubert-xlarge"]
# tests/test_models_smoke.py's tolerance for prefill / decode logits.
DECODE_TOL = dict(atol=2e-3, rtol=1e-3)


def _np(x):
    return np.asarray(x, np.float32)


def _jax_params(cfg, seed=0):
    params = JaxModel(cfg).init_params(jax.random.PRNGKey(seed), jnp.float32)
    return params, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("arch", ARCHS + FAMILIES)
def test_configs_are_copies(arch):
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.num_blocks == ref.num_blocks
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.block_has_attn() == ref.block_has_attn()
        assert port.block_has_mamba() == ref.block_has_mamba()
        assert ([port.sublayer_is_moe(i) for i in range(8)]
                == [ref.sublayer_is_moe(i) for i in range(8)])
        assert (blk._sublayer_kinds(port)
                == jax_blk._sublayer_kinds(ref))


def test_arch_ids_are_the_jax_packages():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert sorted(ARCHS + FAMILIES) == sorted(ARCH_IDS)


@pytest.mark.parametrize("get", [get_config, get_smoke_config])
def test_unknown_arch_raises_key_error(get):
    with pytest.raises(KeyError, match="unknown arch"):
        get("no-such-arch")


def test_rms_norm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        _np(jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5, rtol=1e-5)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                          1e6).numpy(),
        _np(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5, rtol=1e-5)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.1
         for k, s in (("wi", (64, 96)), ("wg", (64, 96)), ("wo", (96, 64)))}
    h = x[:, :, 0]
    np.testing.assert_allclose(
        layers.mlp({k: torch.from_numpy(v) for k, v in w.items()},
                   torch.from_numpy(h)).numpy(),
        _np(jax_layers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                           jnp.asarray(h))),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-0.5b"])
def test_attention_forward_matches_jax(arch):
    cfg = jax_smoke(arch)
    jp, np_params = _jax_params(cfg)
    one = jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"]["mixer"])
    if cfg.qkv_bias:     # zeros at init: give the bias path real values
        rng = np.random.default_rng(5)
        one = {k: (jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
                   * 0.1 if k.startswith("b") else v) for k, v in one.items()}
    x = np.random.default_rng(1).standard_normal(
        (2, 48, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(48, dtype=np.int32), (2, 48)).copy()
    fwd = jax.jit(jax_attn.attention_forward, static_argnums=1)
    want = fwd(one, cfg, jnp.asarray(x), jnp.asarray(pos))
    port = params_from_jax(jax.tree.map(np.asarray, one), device="cpu")
    got = attn.attention_forward(port, get_smoke_config(arch),
                                 torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_port_attention_matches_flash_attention_jnp(causal, window):
    """The kernel's plain version on the model's [B, S, H, D] layout
    against the jnp flash attention the JAX model calls."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 64, 8, 64)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 64)).astype(np.float32)
    want = jax_attn.flash_attention_jnp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, chunk_q=32, chunk_k=32)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), _np(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch,layers_", [("qwen3-4b", None),
                                          ("qwen3-8b", 6),
                                          ("qwen2-0.5b", None),
                                          ("mamba2-370m", None)])
def test_model_forward_matches_jax(arch, layers_):
    cfg = jax_smoke(arch)
    if layers_:
        cfg = dataclasses.replace(cfg, num_layers=layers_)
    jp, np_params = _jax_params(cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    want, _ = JaxModel(cfg).forward(jp, tokens=jnp.asarray(tokens))
    port_cfg = dataclasses.replace(get_smoke_config(arch),
                                   num_layers=cfg.num_layers)
    got, stats = Model(port_cfg).forward(
        params_from_jax(np_params, device="cpu"),
        tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert {k: float(v) for k, v in stats.items()} == dict(blk.ZERO_STATS)
    # ...and from embeddings (the embedding-input path of Model.forward)
    x = np.asarray(jp["embed"]["table"])[tokens]
    got_e, _ = Model(port_cfg).forward(
        params_from_jax(np_params, device="cpu"), embeds=torch.from_numpy(x))
    np.testing.assert_allclose(got_e.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_forward_matches_jax(arch):
    """Logits and router statistics of every new family's smoke config;
    llava and hubert through ``embeds=`` (their frontends are stubs)."""
    cfg = jax_smoke(arch)
    jp, np_params = _jax_params(cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    params = params_from_jax(np_params, device="cpu")
    model = Model(get_smoke_config(arch))
    if cfg.embedding_inputs:
        x = np.random.default_rng(4).standard_normal(
            (2, 40, cfg.d_model)).astype(np.float32) * cfg.d_model ** -0.5
        want, want_stats = JaxModel(cfg).forward(jp, embeds=jnp.asarray(x))
        got, stats = model.forward(params, embeds=torch.from_numpy(x))
    else:
        want, want_stats = JaxModel(cfg).forward(jp,
                                                 tokens=jnp.asarray(tokens))
        got, stats = model.forward(params, tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert stats.keys() == want_stats.keys()
    for k, v in stats.items():
        assert v.dtype == torch.float32 and v.dim() == 0
        np.testing.assert_allclose(float(v), float(want_stats[k]),
                                   err_msg=k, **TOL)
    if cfg.moe is not None:
        assert float(stats["aux_loss"]) > 0


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-0.5b", "mamba2-370m"]
                         + FAMILIES)
def test_init_params_mirror_jax_tree(arch):
    """Same nested layout, shapes and init scales as the JAX init."""
    cfg = jax_smoke(arch)
    _, ref = _jax_params(cfg)
    port = Model(get_smoke_config(arch)).init_params(0, device="cpu")
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat = {}

    def walk(node, path):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            else:
                flat[path + (key,)] = val
    walk(port, ())
    assert len(flat) == len(ref_leaves)
    for path, leaf in ref_leaves:
        key = tuple(p.key for p in path)
        t = flat[key]
        assert tuple(t.shape) == leaf.shape, key
        if leaf.std() > 0:       # random leaves: same scale within 10%
            assert abs(float(t.std()) / float(leaf.std()) - 1) < 0.1, key
        else:                    # ones / zeros
            np.testing.assert_array_equal(t.numpy(), leaf)


def test_init_block_has_one_blocks_leaves():
    cfg = get_smoke_config("qwen2-0.5b")
    one = blk.init_block(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    stacked = Model(cfg).init_params(0, device="cpu")["blocks"]
    ref = blk.block_params(stacked, 0)
    assert one.keys() == ref.keys() == {"sub0"}
    for name in ("ln1", "mixer", "ln2", "ffn"):
        for leaf, t in one["sub0"][name].items():
            assert t.shape == ref["sub0"][name][leaf].shape, (name, leaf)


def test_params_from_jax_dtype_and_device():
    cfg = jax_smoke("qwen3-4b")
    _, ref = _jax_params(cfg)
    port = params_from_jax(ref, dtype=torch.bfloat16, device="cpu")
    t = port["blocks"]["sub0"]["mixer"]["wq"]
    assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
    assert tuple(t.shape) == ref["blocks"]["sub0"]["mixer"]["wq"].shape


def test_block_forward_attn_impl_ref_equals_auto_on_cpu():
    cfg = get_smoke_config("qwen3-4b")
    params = Model(cfg).init_params(1, device="cpu")
    bp = blk.block_params(params["blocks"], 1)
    x = torch.randn(1, 20, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(20).expand(1, 20)
    torch.testing.assert_close(
        blk.block_forward(bp, cfg, x, pos),
        blk.block_forward(bp, cfg, x, pos, impl="ref"),
        atol=0.0, rtol=0.0)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(get_smoke_config("qwen3-4b")).init_params(0)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"w": np.zeros(2, np.float32)})


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def _mamba_setup(seed=0):
    cfg = jax_smoke("mamba2-370m")
    jp, _ = _jax_params(cfg, seed)
    one = jax.tree.map(lambda a: a[0], jp["blocks"]["sub0"]["mixer"])
    port = params_from_jax(jax.tree.map(np.asarray, one), device="cpu")
    return cfg, one, port


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("fn", ["segsum", "ssd_chunked", "ssd_step",
                                "causal_conv", "mamba_forward",
                                "mamba_decode"])
def test_mamba_function_matches_jax(fn):
    cfg, jparams, params = _mamba_setup()
    s = cfg.ssm
    din, N = s.d_inner(cfg.d_model), s.d_state
    H, P = s.num_heads(cfg.d_model), s.head_dim
    rng = np.random.default_rng(7)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa
    if fn == "segsum":
        x = r(3, 16) * 0.1
        got, want = mamba.segsum(_t(x)), jax_mamba.segsum(jnp.asarray(x))
        np.testing.assert_array_equal(np.isinf(got.numpy()),
                                      np.isinf(np.asarray(want)))
        got, want = torch.exp(got), jnp.exp(want)
    elif fn == "ssd_chunked":
        x, B, C, s0 = r(2, 64, H, P), r(2, 64, N), r(2, 64, N), r(2, H, P, N)
        dt = np.logaddexp(r(2, 64, H), 0)
        A = -np.exp(r(H) * 0.5)
        got = mamba.ssd_chunked(*map(_t, (x, dt, A, B, C)), chunk=16,
                                init_state=_t(s0))
        want = jax_mamba.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)),
                                     chunk=16, init_state=jnp.asarray(s0))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   **TOL)
        got, want = got[0], want[0]
    elif fn == "ssd_step":
        x, dt, B, C, st = r(2, H, P), r(2, H) ** 2, r(2, N), r(2, N), \
            r(2, H, P, N)
        A = -np.exp(r(H))
        got = mamba.ssd_step(*map(_t, (x, dt, A, B, C, st)))
        want = jax_mamba.ssd_step(*map(jnp.asarray, (x, dt, A, B, C, st)))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   **TOL)
        got, want = got[0], want[0]
    elif fn == "causal_conv":
        xbc, init = r(2, 12, din + 2 * N), r(2, s.d_conv - 1, din + 2 * N)
        w, b = jparams["conv_w"], r(din + 2 * N)
        for ini in (None, init):
            got = mamba._causal_conv(_t(xbc), _t(w), _t(b),
                                     None if ini is None else _t(ini))
            want = jax_mamba._causal_conv(jnp.asarray(xbc), w, jnp.asarray(b),
                                          None if ini is None
                                          else jnp.asarray(ini))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    elif fn == "mamba_forward":
        x = r(2, 48, cfg.d_model)
        got = mamba.mamba_forward(params, get_smoke_config("mamba2-370m"),
                                  _t(x))
        want = jax_mamba.mamba_forward(jparams, cfg, jnp.asarray(x))
    else:
        x = r(2, 1, cfg.d_model)
        cache = {"conv": r(2, s.d_conv - 1, din + 2 * N),
                 "ssm": r(2, H, P, N) * 0.1}
        got, new = mamba.mamba_decode(
            params, get_smoke_config("mamba2-370m"), _t(x),
            {k: _t(v) for k, v in cache.items()})
        want, jnew = jax_mamba.mamba_decode(
            jparams, cfg, jnp.asarray(x),
            {k: jnp.asarray(v) for k, v in cache.items()})
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                       **TOL)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_mamba_scan_chunk_on_kernel_route_is_the_configs(monkeypatch):
    """For an odd S the JAX rule halves the chunk down to 1; the kernel
    masks a short last chunk, so its route gets the config's chunk as it
    is.  The chunk handed to ``ops.ssd_scan`` is recorded, not launched."""
    cfg = get_smoke_config("mamba2-370m")
    _, _, params = _mamba_setup()
    seen = []

    def record(x, dt, A, B, C, *, chunk, impl):
        seen.append(chunk)
        b, S, H, P = x.shape
        return (torch.zeros_like(x),
                torch.zeros((b, H, P, B.shape[-1]), dtype=torch.float32))

    monkeypatch.setattr(mamba.ops, "ssd_scan", record)
    x = torch.randn((1, 1025, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    mamba.mamba_forward(params, cfg, x, impl="cuda")
    assert seen == [cfg.ssm.chunk_size]
    assert mamba._chunk(cfg.ssm.chunk_size, 1025) == 1


@pytest.mark.parametrize("S", [40, 2])
def test_mamba_prefill_cache_matches_jax(S):
    """The conv cache (zero-padded when S < d_conv - 1) and the final SSM
    state that prefill hands to decode."""
    cfg, jparams, params = _mamba_setup(seed=2)
    x = np.random.default_rng(8).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    got, cache = blk.mamba_prefill(params, get_smoke_config("mamba2-370m"),
                                   _t(x))
    want, jcache = jax_blk.mamba_prefill(jparams, cfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for k in ("conv", "ssm"):
        assert tuple(cache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), _np(jcache[k]), **TOL)


@pytest.mark.parametrize("arch,window", [("qwen3-4b", None),
                                         ("qwen2-0.5b", None),
                                         ("mamba2-370m", None),
                                         ("qwen3-4b", 24)])
def test_prefill_decode_match_jax_and_forward(arch, window):
    """Prefill + two decode steps against the JAX package's prefill and
    decode_step and against the full forward (tests/test_models_smoke.py's
    check and tolerance).  Every call gets a cache of its own: the port
    updates caches in place."""
    B, S = 2, 64
    cfg = dataclasses.replace(jax_smoke(arch), sliding_window=window)
    port_cfg = dataclasses.replace(get_smoke_config(arch),
                                   sliding_window=window)
    model = JaxModel(cfg)
    jp, np_params = _jax_params(cfg, seed=1)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S + 2))
    full, _ = model.forward(jp, tokens=jnp.asarray(toks))
    jcache = model.init_cache(B, S + 8, jnp.float32)
    jlp, jcache = model.prefill(jp, tokens=jnp.asarray(toks[:, :S]),
                                cache=jcache)
    jlg, _ = model.decode_step(jp, jnp.asarray(toks[:, S:S + 1]), jcache,
                               jnp.array(S, jnp.int32))

    port = Model(port_cfg)
    params = params_from_jax(np_params, device="cpu")
    cache = port.init_cache(B, S + 8, torch.float32, device="cpu")
    t = torch.from_numpy(toks)
    lp, cache = port.prefill(params, tokens=t[:, :S], cache=cache)
    assert tuple(lp.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(lp.numpy(), _np(jlp), **DECODE_TOL)
    np.testing.assert_allclose(lp[:, 0].numpy(), _np(full[:, S - 1]),
                               **DECODE_TOL)
    for step in range(2):
        lg, cache = port.decode_step(params, t[:, S + step:S + step + 1],
                                     cache, S + step)
        np.testing.assert_allclose(lg[:, 0].numpy(), _np(full[:, S + step]),
                                   **DECODE_TOL)
        if step == 0:
            np.testing.assert_allclose(lg.numpy(), _np(jlg), **DECODE_TOL)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b",
                                  "llava-next-34b", "jamba-1.5-large-398b"])
def test_family_prefill_decode_match_jax_and_forward(arch):
    """Prefill + two decode steps of the new decoder families against the
    JAX package's prefill and decode_step and against the port's forward,
    at DECODE_TOL (llava prefills from embeddings).  As
    tests/test_models_smoke.py does, the capacity is raised so that no
    (token, choice) pair is dropped: drops depend on the group, which
    differs between a prefill and a forward over more tokens."""
    B, S = 2, 64
    cfg = jax_smoke(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)
            / cfg.moe.num_experts_per_tok))
    port_cfg = dataclasses.replace(
        get_smoke_config(arch),
        moe=None if cfg.moe is None else MoEConfig(
            **dataclasses.asdict(cfg.moe)))
    model = JaxModel(cfg)
    jp, np_params = _jax_params(cfg, seed=1)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S + 2))
    table = np.asarray(np_params["embed"]["table"])
    if cfg.embedding_inputs:
        jpre = dict(embeds=jnp.asarray(table[toks[:, :S]]))
        pre = dict(embeds=torch.from_numpy(table[toks[:, :S]]))
        full_in = dict(embeds=torch.from_numpy(table[toks]))
    else:
        jpre = dict(tokens=jnp.asarray(toks[:, :S]))
        pre = dict(tokens=torch.from_numpy(toks[:, :S]))
        full_in = dict(tokens=torch.from_numpy(toks))
    jcache = model.init_cache(B, S + 8, jnp.float32)
    jlp, jcache = model.prefill(jp, cache=jcache, **jpre)
    jlg, _ = model.decode_step(jp, jnp.asarray(toks[:, S:S + 1]), jcache,
                               jnp.array(S, jnp.int32))

    port = Model(port_cfg)
    params = params_from_jax(np_params, device="cpu")
    full, stats = port.forward(params, **full_in)
    if cfg.moe is not None:
        assert float(stats["dropped_frac"]) == 0
    cache = port.init_cache(B, S + 8, torch.float32, device="cpu")
    lp, cache = port.prefill(params, cache=cache, **pre)
    assert tuple(lp.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(lp.numpy(), _np(jlp), **DECODE_TOL)
    np.testing.assert_allclose(lp[:, 0].numpy(), full[:, S - 1].numpy(),
                               **DECODE_TOL)
    t = torch.from_numpy(toks)
    for step in range(2):
        lg, cache = port.decode_step(params, t[:, S + step:S + step + 1],
                                     cache, S + step)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, S + step].numpy(), **DECODE_TOL)
        if step == 0:
            np.testing.assert_allclose(lg.numpy(), _np(jlg), **DECODE_TOL)


def test_init_normal_draws_in_place():
    """The init draws straight into the leaf: the dtype asked for, the
    scale asked for, no fp32 copy of a bf16 leaf."""
    w = layers.init_normal(torch.Generator().manual_seed(0), (4, 64, 256),
                           0.05, torch.bfloat16, "cpu")
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (4, 64, 256)
    assert abs(float(w.float().std()) / 0.05 - 1) < 0.05
    assert abs(float(w.float().mean())) < 5e-3


def test_bridge_and_init_keep_ssm_leaves_fp32():
    """A_log, D and dt_bias stay fp32 when the model is asked for bf16,
    as the JAX init keeps them."""
    cfg = jax_smoke("mamba2-370m")
    _, ref = _jax_params(cfg)
    for params in (params_from_jax(ref, dtype=torch.bfloat16, device="cpu"),
                   Model(get_smoke_config("mamba2-370m")).init_params(
                       0, dtype=torch.bfloat16, device="cpu")):
        mixer = params["blocks"]["sub0"]["mixer"]
        for name, t in mixer.items():
            want = (torch.float32 if name in mamba.FP32_LEAVES
                    else torch.bfloat16)
            assert t.dtype == want, name
        assert set(mamba.FP32_LEAVES) <= set(mixer)
    got = params_from_jax(ref, dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(
        got["blocks"]["sub0"]["mixer"]["A_log"].numpy(),
        ref["blocks"]["sub0"]["mixer"]["A_log"])
