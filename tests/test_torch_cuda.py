"""Tests that need an NVIDIA card (Hopper, sm_90a): the port's CUDA
kernels against their plain versions, and the model and serving path
through them.  They import neither JAX nor the JAX package, so they run on
a machine that has the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Where there is no card they skip.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    BATCHED_MAIN_CASES,
    DECODE_CASES,
    DECODE_CORNER_CASES,
    DECODE_FAMILY_MAIN_CASES,
    DECODE_MAIN_CASE,
    DECODE_MAIN_RMS_LIMIT,
    DECODE_MAIN_TOLERANCE,
    DECODE_RAGGED_CASES,
    FAMILY_MAIN_CASES,
    FLASH_CASES,
    MAIN_CASES,
    MAIN_RMS_LIMIT,
    MAIN_TOLERANCE,
    RAGGED_CASES,
    SSD_BATCHED_MAIN_CASE,
    SSD_CASES,
    SSD_CORNER_CASES,
    SSD_FAMILY_MAIN_CASES,
    SSD_MAIN_CASE,
    SSD_MAIN_RMS_LIMIT,
    SSD_MAIN_TOLERANCE,
    SSD_RAGGED_CASES,
    SSD_STATE_RMS_LIMIT,
    TENSOR_CORE_CASES,
    case_id,
    decode_case_id,
    max_ratio,
    ssd_case_id,
    ssd_limit,
    tolerance,
)
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    decode_attention_ref,
    flash_attention_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.schedulers.runtime import RuntimeStep  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import engine as engine_lib  # noqa: E402
from repro_torch.workloads import resolve_batching  # noqa: E402


def _inputs(shapes, dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device="cuda", dtype=getattr(torch, dtype)) for s in shapes]


def _to_card(tree: dict) -> dict:
    return {k: _to_card(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


def _rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def _assert_close_by_rms(got, want, tol: dict, rms_limit: float) -> None:
    """|got - want| <= atol + rtol |want| everywhere, and rms(got - want)
    <= rms_limit rms(want)."""
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert _rms(got.float() - want.float()) <= rms_limit * _rms(want)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _route_counts():
    return (flash_attention.launches, flash_attention.tensor_core_launches,
            flash_attention.cuda_core_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES
                         + TENSOR_CORE_CASES, ids=case_id)
def test_kernel_matches_plain_version(card, case):
    """bf16 runs on the tensor-core kernel, fp32 on the CUDA-core one."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    n, tc, cc = _route_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="cuda")
    torch.cuda.synchronize()
    bf16 = dtype == "bfloat16"
    assert _route_counts() == (n + 1, tc + bf16, cc + (not bf16))
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **tolerance(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MAIN_CASES, ids=case_id)
def test_kernel_matches_plain_version_at_main_path_shape(card, case):
    """Contiguous q/k/v, and views of one [B, S, H, D] projection as the
    model hands them over (read in place through TMA)."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    (x,) = _inputs([(B, S, Hq + 2 * Hkv, D)], dtype, seed=3)
    views = (x[:, :, :Hq].transpose(1, 2),
             x[:, :, Hq:Hq + Hkv].transpose(1, 2),
             x[:, :, Hq + Hkv:].transpose(1, 2))
    for q, k, v in ((q, k, v), views):
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="cuda")
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        _assert_close_by_rms(got, want, MAIN_TOLERANCE, MAIN_RMS_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BATCHED_MAIN_CASES, ids=case_id)
def test_kernel_matches_plain_version_at_batched_main_shapes(card, case):
    """A formed dispatch of 8 rows at a bucket edge, on the tensor-core
    kernel, at the main limits."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype,
                      seed=6)
    n = flash_attention.tensor_core_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="cuda")
    torch.cuda.synchronize()
    assert flash_attention.tensor_core_launches == n + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    _assert_close_by_rms(got, want, MAIN_TOLERANCE, MAIN_RMS_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FAMILY_MAIN_CASES, ids=case_id)
def test_kernel_matches_plain_version_at_family_shapes(card, case):
    """The MoE and embedding-input families' attention at their published
    widths (MHA, D 80 bidirectional, group 7 at S 2944, a window that
    bites), on the tensor-core kernel, at the main limits."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype,
                      seed=10)
    n = flash_attention.tensor_core_launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="cuda")
    torch.cuda.synchronize()
    assert flash_attention.tensor_core_launches == n + 1
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    _assert_close_by_rms(got, want, MAIN_TOLERANCE, MAIN_RMS_LIMIT)


@pytest.mark.cuda
def test_bf16_kernel_rejects_misaligned_views(card):
    """TMA needs strides that are multiples of 16 bytes: a view that breaks
    the rule is refused, never read wrong."""
    (x,) = _inputs([(1, 64, 4 * 64 + 4)], "bfloat16")
    q = x[:, :, :256].reshape(1, 64, 4, 64).transpose(1, 2)
    assert q.stride(2) % 8
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.flash_attention(q, q[:, :2], q[:, :2], impl="cuda")


@pytest.mark.cuda
def test_kernel_reads_model_layout_in_place(card):
    """q/k/v as the model hands them over: views of one [B, S, H, D]
    projection; the output comes back in that layout."""
    B, Hq, Hkv, S, D = 2, 8, 2, 100, 128
    (x,) = _inputs([(B, S, Hq + 2 * Hkv, D)], "bfloat16", seed=1)
    q = x[:, :, :Hq].transpose(1, 2)
    k = x[:, :, Hq:Hq + Hkv].transpose(1, 2)
    v = x[:, :, Hq + Hkv:].transpose(1, 2)
    got = ops.flash_attention(q, k, v, impl="cuda")
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v).float(),
                               **tolerance("bfloat16"))


@pytest.mark.cuda
def test_model_forward_on_card_matches_cpu(card):
    cfg = get_smoke_config("qwen3-4b")
    params = Model(cfg).init_params(0, device="cpu")
    tokens = torch.as_tensor(
        np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 96)))
    with torch.inference_mode():
        want, _ = Model(cfg).forward(params, tokens)
        n = flash_attention.launches
        got, _ = Model(cfg).forward(_to_card(params), tokens.cuda())
    assert flash_attention.launches == n + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b", "llava-next-34b",
                                  "hubert-xlarge"])
def test_family_forward_on_card_matches_cpu(card, arch):
    """The smoke configs of the MoE and embedding-input families in fp32:
    logits and router statistics on the card against the CPU, K1 once per
    attention sublayer and K3 once per Mamba2 sublayer."""
    cfg = get_smoke_config(arch)
    params = Model(cfg).init_params(0, device="cpu")
    rng = np.random.default_rng(2)
    if cfg.embedding_inputs:
        inputs = dict(embeds=torch.as_tensor(
            rng.standard_normal((2, 96, cfg.d_model)).astype(np.float32)
            * cfg.d_model ** -0.5))
    else:
        inputs = dict(tokens=torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 96))))
    with torch.inference_mode():
        want, want_stats = Model(cfg).forward(params, **inputs)
        n, m = flash_attention.launches, ssd_scan.launches
        got, stats = Model(cfg).forward(
            _to_card(params), **{k: v.cuda() for k, v in inputs.items()})
    assert flash_attention.launches == n + cfg.num_blocks \
        * cfg.layer_pattern.count("attn")
    assert ssd_scan.launches == m + cfg.num_blocks \
        * cfg.layer_pattern.count("mamba")
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for k, v in stats.items():
        torch.testing.assert_close(v.cpu(), want_stats[k], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.cuda
def test_serving_runs_every_block_through_kernel(card):
    cfg = get_smoke_config("qwen3-4b")
    params = Model(cfg).init_params(0, device="cuda")
    eng = ServingEngine(cfg, params, num_eps=2, device="cuda")
    eng.executor.warmup(1, 64)
    rng = np.random.default_rng(3)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 64)),
                               device="cuda") for _ in range(4)]
    flash_attention.launches = 0
    trace = eng.serve(queries, lambda q: [1.0, 1.0])
    assert flash_attention.launches == cfg.num_layers * len(queries)
    assert all(sum(c) == cfg.num_blocks for c in trace.configs)
    with torch.inference_mode():
        bp = blk.block_params(eng.executor.params["blocks"], 0)
        (x,) = _inputs([(1, 64, cfg.d_model)], "float32", seed=4)
        pos = torch.arange(64, device="cuda").expand(1, 64)
        torch.testing.assert_close(
            blk.block_forward(bp, cfg, x, pos)[0],
            blk.block_forward(bp, cfg, x, pos, impl="ref")[0],
            atol=1e-4, rtol=1e-4)


def _ssd_inputs(b, S, H, P, N, dtype, seed=0, slow=False):
    """x, B, C normal; A = -exp(normal / 2); dt = softplus(normal) as the
    JAX kernel test draws it, or with ``slow`` log-uniform in [1e-3, 1e-1]
    (the range Mamba2 initialises dt to), where the state decays slowly and
    carries across chunks."""
    rng = np.random.default_rng(seed)
    x, B, C = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, S, H, P), (b, S, N), (b, S, N)))
    dt = (np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, S, H))) if slow
          else np.logaddexp(rng.standard_normal((b, S, H)), 0))
    A = -np.exp(rng.standard_normal(H) * 0.5)
    return [torch.from_numpy(a.astype(np.float32)).to(
        device="cuda", dtype=getattr(torch, dtype)) for a in (x, dt, A, B, C)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES + SSD_RAGGED_CASES
                         + SSD_CORNER_CASES, ids=ssd_case_id)
def test_ssd_kernel_matches_plain_version(card, case):
    b, S, H, P, N, chunk, dtype = case
    ins = _ssd_inputs(b, S, H, P, N, dtype)
    n = ssd_scan.launches
    y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
    torch.cuda.synchronize()
    assert ssd_scan.launches == n + 1
    assert y.dtype == ins[0].dtype and state.dtype == torch.float32
    y_ref, s_ref = ssd_scan_ref(*ins)
    assert max_ratio(y, y_ref) < ssd_limit(dtype)
    assert max_ratio(state, s_ref) < ssd_limit("float32")   # fp32 in both


@pytest.mark.cuda
@pytest.mark.parametrize("slow", [False, True], ids=["jax_dt", "slow_decay"])
def test_ssd_kernel_matches_plain_version_at_main_path_shape(card, slow):
    b, S, H, P, N, chunk, dtype = SSD_MAIN_CASE
    ins = _ssd_inputs(b, S, H, P, N, dtype, slow=slow)
    y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
    y_ref, s_ref = ssd_scan_ref(*ins)
    _assert_close_by_rms(y, y_ref, SSD_MAIN_TOLERANCE, SSD_MAIN_RMS_LIMIT)
    assert max_ratio(state, s_ref) < ssd_limit("float32")
    assert _rms(state - s_ref) <= SSD_STATE_RMS_LIMIT * _rms(s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("slow", [False, True], ids=["jax_dt", "slow_decay"])
def test_ssd_kernel_matches_plain_version_at_batched_main_shape(card, slow):
    b, S, H, P, N, chunk, dtype = SSD_BATCHED_MAIN_CASE
    ins = _ssd_inputs(b, S, H, P, N, dtype, seed=7, slow=slow)
    y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
    y_ref, s_ref = ssd_scan_ref(*ins)
    _assert_close_by_rms(y, y_ref, SSD_MAIN_TOLERANCE, SSD_MAIN_RMS_LIMIT)
    assert max_ratio(state, s_ref) < ssd_limit("float32")
    assert _rms(state - s_ref) <= SSD_STATE_RMS_LIMIT * _rms(s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_FAMILY_MAIN_CASES, ids=ssd_case_id)
@pytest.mark.parametrize("slow", [False, True], ids=["jax_dt", "slow_decay"])
def test_ssd_kernel_matches_plain_version_at_family_shapes(card, case, slow):
    """jamba's Mamba2 sublayers at its published width (H 256) and at its
    smoke width (N 32, chunk 32), at the main limits."""
    b, S, H, P, N, chunk, dtype = case
    ins = _ssd_inputs(b, S, H, P, N, dtype, seed=11, slow=slow)
    y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
    y_ref, s_ref = ssd_scan_ref(*ins)
    _assert_close_by_rms(y, y_ref, SSD_MAIN_TOLERANCE, SSD_MAIN_RMS_LIMIT)
    assert max_ratio(state, s_ref) < ssd_limit("float32")
    assert _rms(state - s_ref) <= SSD_STATE_RMS_LIMIT * _rms(s_ref)


@pytest.mark.cuda
def test_ssd_kernel_depends_on_chunk_only_through_rounding(card):
    ins = _ssd_inputs(1, 300, 4, 64, 128, "float32", seed=1)
    y1, s1 = ops.ssd_scan(*ins, chunk=256, impl="cuda")
    y2, s2 = ops.ssd_scan(*ins, chunk=37, impl="cuda")
    assert max_ratio(y1, y2) < 1e-5 and max_ratio(s1, s2) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES + DECODE_RAGGED_CASES
                         + DECODE_CORNER_CASES + [DECODE_MAIN_CASE],
                         ids=decode_case_id)
def test_decode_kernel_matches_plain_version(card, case):
    B, Hq, Hkv, S, D, idx, window, dtype = case
    q, k, v = _inputs([(B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    n = decode_attention.launches
    index = torch.tensor(idx, dtype=torch.int32, device="cuda")
    got = ops.decode_attention(q, k, v, index, window=window, impl="cuda")
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    want = decode_attention_ref(q, k, v, idx, window=window)
    if case == DECODE_MAIN_CASE:
        _assert_close_by_rms(got, want, DECODE_MAIN_TOLERANCE,
                             DECODE_MAIN_RMS_LIMIT)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   **tolerance(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(1, 9))
def test_decode_kernel_main_case_holds_over_draws(card, seed):
    """DECODE_MAIN_TOLERANCE and DECODE_MAIN_RMS_LIMIT on several draws: a
    single bf16 output one ulp off reads an rms over the limit."""
    B, Hq, Hkv, S, D, idx, window, dtype = DECODE_MAIN_CASE
    q, k, v = _inputs([(B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype,
                      seed=seed)
    got = ops.decode_attention(q, k, v, idx, window=window, impl="cuda")
    _assert_close_by_rms(got, decode_attention_ref(q, k, v, idx,
                                                   window=window),
                         DECODE_MAIN_TOLERANCE, DECODE_MAIN_RMS_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_FAMILY_MAIN_CASES, ids=decode_case_id)
def test_decode_kernel_matches_plain_version_at_family_shapes(card, case):
    """deepseek (MHA), llava and mixtral (past its window) decode, read
    strided from a [B, S, Hkv, D] cache, at the main limits."""
    B, Hq, Hkv, S, D, idx, window, dtype = case
    q, cache_k, cache_v = _inputs([(B, Hq, D), (B, S, Hkv, D),
                                   (B, S, Hkv, D)], dtype, seed=12)
    k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    index = torch.tensor(idx, dtype=torch.int32, device="cuda")
    n = decode_attention.launches
    got = ops.decode_attention(q, k, v, index, window=window, impl="cuda")
    torch.cuda.synchronize()
    assert decode_attention.launches == n + 1
    _assert_close_by_rms(got, decode_attention_ref(q, k, v, idx,
                                                   window=window),
                         DECODE_MAIN_TOLERANCE, DECODE_MAIN_RMS_LIMIT)


@pytest.mark.cuda
def test_decode_kernel_ignores_stale_slots_and_reads_cache_in_place(card):
    B, Hq, Hkv, S, D = 1, 32, 8, 512, 128
    q, cache_k, cache_v = _inputs([(B, Hq, D), (B, S, Hkv, D),
                                   (B, S, Hkv, D)], "bfloat16", seed=2)
    k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
    out1 = ops.decode_attention(q, k, v, 300, impl="cuda")
    cache_k[:, 301:] = 99.0
    cache_v[:, 301:] = -99.0
    out2 = ops.decode_attention(q, k, v, 300, impl="cuda")
    torch.testing.assert_close(out1, out2, atol=0.0, rtol=0.0)
    torch.testing.assert_close(
        out1.float(), decode_attention_ref(q, k.contiguous(), v.contiguous(),
                                           300).float(),
        **tolerance("bfloat16"))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m",
                                  "deepseek-moe-16b", "mixtral-8x22b",
                                  "jamba-1.5-large-398b"])
def test_prefill_decode_on_card_match_cpu(card, arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init_params(0, device="cpu")
    toks = torch.as_tensor(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 66)))
    outs = []
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else _to_card(params)
        cache = model.init_cache(2, 72, torch.float32, device=dev)
        t = toks.to(dev)
        with torch.inference_mode():
            lp, cache = model.prefill(p, tokens=t[:, :64], cache=cache)
            lg, cache = model.decode_step(p, t[:, 64:65], cache, 64)
            lg2, _ = model.decode_step(p, t[:, 65:66], cache, 65)
        outs.append([o.cpu() for o in (lp, lg, lg2)])
    for want, got in zip(*outs):
        torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.cuda
def test_mamba_serving_runs_every_block_through_ssd_kernel(card):
    cfg = get_smoke_config("mamba2-370m")
    params = Model(cfg).init_params(0, device="cuda")
    eng = ServingEngine(cfg, params, num_eps=2, device="cuda")
    eng.executor.warmup(1, 64)
    rng = np.random.default_rng(3)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 64)),
                               device="cuda") for _ in range(4)]
    ssd_scan.launches = 0
    trace = eng.serve(queries, lambda q: [1.0, 1.0])
    assert ssd_scan.launches == cfg.num_layers * len(queries)
    assert all(sum(c) == cfg.num_blocks for c in trace.configs)


def _dispatch_with_a_join(eng, queries, lengths):
    """Drive one continuous dispatch through the engine's builder: queries
    0 and 1 formed, query 2 joining after stage 1; returns the builder."""
    live = eng.query_executor(queries, lambda q: [1.0] * eng.num_eps)
    former = resolve_batching("continuous", max_batch=4,
                              buckets="pow2:32:64", seq=64)
    lengths = np.asarray(lengths)
    live.configure_batching(former, lengths, former.padded_lengths(lengths))
    live.begin_query(0)
    builder = live.begin_dispatch(0, RuntimeStep(eng.config, serial=False))
    builder.add(0)
    builder.add(1)
    assert builder.next_boundary() is not None
    builder.join(2)
    builder.finish()
    return builder


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m"])
def test_batched_padded_rows_equal_queries_alone_fp32(card, arch):
    """On the card in fp32: each row of a continuous dispatch with a join,
    right-padded to its bucket edge, gives on its real positions the
    logits the query gives alone."""
    cfg = get_smoke_config(arch)
    params = Model(cfg).init_params(0, device="cuda")
    eng = ServingEngine(cfg, params, num_eps=2, device="cuda")
    rng = np.random.default_rng(8)
    lengths = [40, 64, 50]
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                               device="cuda") for n in lengths]
    builder = _dispatch_with_a_join(eng, queries, lengths)
    with torch.inference_mode():
        logits = eng.executor.head(builder._x)
        for i, n in enumerate(lengths):
            alone, _ = eng.executor.run_query(queries[i], eng.config)
            torch.testing.assert_close(logits[i, :n], alone[0], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.cuda
def test_continuous_serve_on_card_with_a_join(card, monkeypatch):
    """A continuous serve on the card: queries 1 microsecond apart, so the
    second joins the first's dispatch at its first stage boundary; every
    attention runs through K1, once per block forward the executor ran."""
    cfg = get_smoke_config("qwen3-4b")
    params = Model(cfg).init_params(0, device="cuda")
    eng = ServingEngine(cfg, params, num_eps=2, device="cuda")
    rng = np.random.default_rng(9)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, int(n))), device="cuda")
               for n in rng.choice([40, 64], 12)]
    joins, blocks = [], []
    join = engine_lib._LiveDispatchBuilder.join
    monkeypatch.setattr(engine_lib._LiveDispatchBuilder, "join",
                        lambda self, q: (joins.append(q), join(self, q)))
    stage_fn = eng.executor.stage_fn
    monkeypatch.setattr(eng.executor, "stage_fn",
                        lambda x, pos, lo, hi: (blocks.append(hi - lo),
                                                stage_fn(x, pos, lo, hi))[1])
    flash_attention.launches = 0
    trace = eng.serve(queries, lambda q: [1.0, 1.0], workload="trace",
                      workload_kwargs=dict(inter_arrivals=[1e-6]),
                      batching="continuous", max_batch=4,
                      buckets="pow2:32:64")
    torch.cuda.synchronize()
    assert len(trace.latencies) == len(queries)
    assert len(joins) >= 1
    assert trace.summary()["mean_batch_occupancy"] > 1.0
    assert flash_attention.launches == sum(blocks) > 0
