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
from repro_torch.kernels import flash_attention as k1_lib  # noqa: E402
from repro_torch.kernels import ssd_scan as k3_lib  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    BACKWARD_BF16_CASES,
    BACKWARD_CASES,
    BACKWARD_LIMIT,
    BACKWARD_TRAIN_CASE,
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
    SSD_BACKWARD_CASES,
    SSD_BACKWARD_TRAIN_CASE,
    SSD_BATCHED_MAIN_CASE,
    SSD_CASES,
    SSD_CORNER_CASES,
    SSD_FAMILY_MAIN_CASES,
    SSD_FP32_MAIN_CASES,
    SSD_MAIN_CASE,
    SSD_MAIN_RMS_LIMIT,
    SSD_MAIN_TOLERANCE,
    SSD_RAGGED_CASES,
    SSD_STATE_RMS_LIMIT,
    TENSOR_CORE_CASES,
    bf16_backward_check,
    case_id,
    decode_case_id,
    max_ratio,
    ssd_backward_check,
    ssd_case_id,
    ssd_limit,
    tolerance,
)
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    decode_attention_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
    ssd_scan_bwd_ref,
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


def _widened(tree: dict) -> dict:
    return {k: _widened(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


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
            flash_attention.fp32_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES
                         + TENSOR_CORE_CASES, ids=case_id)
def test_kernel_matches_plain_version(card, case):
    """bf16 runs on the bf16 kernel, fp32 on the fp32 (3xTF32) one."""
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
    bites) and a mixed fleet's small pool (qwen2-0.5b, group 7 at D 64,
    S 1024), on the tensor-core kernel, at the main limits."""
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
@pytest.mark.parametrize("case", SSD_FP32_MAIN_CASES, ids=ssd_case_id)
@pytest.mark.parametrize("slow", [False, True], ids=["jax_dt", "slow_decay"])
def test_ssd_fp32_route_matches_plain_version_at_training_shapes(card, case,
                                                                 slow):
    """The fp32 route (3xTF32) where the train step runs it: y at the fp32
    JAX limit and at the main limits, the state at the fp32 limit and by
    rms."""
    b, S, H, P, N, chunk, dtype = case
    ins = _ssd_inputs(b, S, H, P, N, dtype, seed=13, slow=slow)
    y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
    y_ref, s_ref = ssd_scan_ref(*ins)
    assert max_ratio(y, y_ref) < ssd_limit(dtype)
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


@pytest.fixture(scope="module")
def qwen_two_blocks():
    """Full-width qwen3-4b cut to 2 blocks, bf16 on the card (a module
    fixture is set up before ``card``, so it asks for the card itself)."""
    import dataclasses

    from repro_torch.configs import get_config
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2)
    params = Model(cfg).init_params(0, dtype=torch.bfloat16, device="cuda")
    rng = np.random.default_rng(11)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 256)),
                               device="cuda") for _ in range(10)]
    return cfg, params, queries


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [None, 8], ids=["flat", "mesh"])
def test_api_run_serves_full_width_blocks_on_card(card, qwen_two_blocks,
                                                  mesh):
    """api.run(RunSpec(engine=...)) under hybrid on two full-width qwen3-4b
    blocks, with and without a mesh: K1 runs once per block and query on
    its tensor-core kernel, and a mesh run keeps every assignment on 8
    devices with collective shares in [0, 1)."""
    from repro_torch import api
    cfg, params, queries = qwen_two_blocks
    eng = ServingEngine(cfg, params, num_eps=2, scheduler="hybrid",
                        alpha=3, device="cuda",
                        mesh=(None if mesh is None
                              else api.MeshSpec(devices=mesh,
                                                coll_cost=1e-4)),
                        coll_factor_schedule=lambda q: 3.0 if q >= 5
                        else 1.0)
    eng.executor.warmup(1, 256)
    flash_attention.launches = 0
    flash_attention.tensor_core_launches = 0
    trace = api.run(api.RunSpec(engine=eng, queries=queries,
                                schedule=lambda q: [1.0, 3.0 if q >= 3
                                                    else 1.0]))
    assert len(trace.latencies) == len(queries)
    assert flash_attention.launches == \
        flash_attention.tensor_core_launches == cfg.num_blocks * len(queries)
    assert all(sum(c) == cfg.num_blocks for c in trace.configs)
    if mesh is None:
        assert trace.mesh_trace is None
    else:
        assert all(sum(a) == mesh and min(a) >= 1 for a in trace.mesh_trace)
        fr = np.asarray(trace.collective_fracs)
        assert np.all((fr >= 0.0) & (fr < 1.0))


@pytest.mark.cuda
def test_simulator_on_a_database_measured_on_card(card, qwen_two_blocks):
    """Block times measured on the card make a layer database; the
    simulator compares the policies over it, the oracle best of all."""
    from repro_torch import api
    from repro_torch.core import generate_events, transformer_database
    cfg, params, queries = qwen_two_blocks
    eng = ServingEngine(cfg, params, num_eps=2, device="cuda")
    bt = eng.executor.measure_block_times(queries[0], repeats=3)
    assert bt.shape == (cfg.num_blocks,) and np.all(bt > 0)
    db = transformer_database(np.tile(bt, 4), seed=0)
    events = generate_events(400, 2, db.num_scenarios, 10, 10, seed=0)
    tput = {}
    for name in ("odin", "lls", "hybrid", "oracle", "none"):
        t = api.run(api.RunSpec(db=db, num_eps=2, num_queries=400,
                                events=events,
                                scheduler=api.SchedulerSpec(name=name)))
        tput[name] = t.summary()["mean_throughput_qps"]
    assert all(np.isfinite(v) and v > 0 for v in tput.values())
    assert tput["oracle"] >= max(tput.values()) * (1 - 1e-9)


@pytest.mark.cuda
def test_measured_db_card_row_on_card(card, qwen_two_blocks):
    """One card co-tenant row over two full-width qwen3-4b blocks: the
    co-tenant runs on the card while the blocks are timed, and the table
    is positive."""
    from repro_torch.launch import measured_db, stressors
    cfg, params, queries = qwen_two_blocks
    eng = ServingEngine(cfg, params, num_eps=2, device="cuda")
    rows = [stressors.scenarios_table1()[0], stressors.card_scenarios()[0]]
    m = measured_db.measure(eng.executor, queries[0], rows, repeats=1,
                            log=lambda _: None)
    assert m.table.shape == (cfg.num_blocks, 2) and np.all(m.table > 0)
    load = m.load["card-matmul-1p"]
    assert load["rate_alone_hz"] > 0 and load["rate_timing_hz"] > 0
    assert load["card_bytes"] > 0


# -- training: K1's backward kernel and a train step on the card ------------


def _k1_counts():
    return (flash_attention.launches, flash_attention.lse_launches,
            flash_attention.backward_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BACKWARD_CASES, ids=case_id)
def test_backward_kernel_matches_plain_version(card, case):
    """dq, dk, dv of csrc/flash_attention_bwd.cu against autograd through
    the plain attention, each within BACKWARD_LIMIT of max |ref|, twice
    with the same bits (no atomics); the LSE entry point's output is the
    plain entry point's, bit for bit."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v, do = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                           (B, Hq, S, D)], dtype, seed=11)
    o, lse = k1_lib.forward_with_lse(q, k, v, causal=causal, window=window)
    n = _k1_counts()
    o_plain = flash_attention(q, k, v, causal=causal, window=window)
    got = k1_lib.backward(q, k, v, o, lse, do, causal=causal, window=window)
    again = k1_lib.backward(q, k, v, o, lse, do, causal=causal,
                            window=window)
    torch.cuda.synchronize()
    assert _k1_counts() == (n[0] + 1, n[1], n[2] + 2)
    assert torch.equal(o, o_plain)
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert max_ratio(g, w) <= BACKWARD_LIMIT, name
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_fp32_forward_and_backward_repeat_bit_for_bit(card):
    """At the training shape the fp32 forward (both entry points) and the
    backward give the same bits on two calls: no atomics, a fixed order of
    the tensor-core products."""
    B, Hq, Hkv, S, D, causal, window, dtype = BACKWARD_TRAIN_CASE
    q, k, v, do = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                           (B, Hq, S, D)], dtype, seed=15)
    runs = []
    for _ in range(2):
        o, lse = k1_lib.forward_with_lse(q, k, v, causal=causal,
                                         window=window)
        o_plain = flash_attention(q, k, v, causal=causal, window=window)
        runs.append((o, lse, o_plain) + k1_lib.backward(
            q, k, v, o, lse, do, causal=causal, window=window))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D,offset", [(56, 0), (20, 0), (64, 1)],
                         ids=["D56", "D20", "D64_unaligned"])
def test_fp32_kernels_take_padded_head_dims_in_model_layout(card, D,
                                                            offset):
    """Head dims that are not multiples of 8 (padded with zero columns in
    shared memory), read in place from the model's [B, S, H, D] layout,
    and that layout one element off 16-byte alignment (the kernels' 4-byte
    copies): the forward within tolerance("float32"), the backward within
    BACKWARD_LIMIT."""
    B, Hq, Hkv, S = 2, 14, 2, 130
    (x,) = _inputs([(B * S * (Hq + 2 * Hkv) * D + offset,)], "float32",
                   seed=16)
    x = x[offset:].view(B, S, Hq + 2 * Hkv, D)
    (do,) = _inputs([(B, Hq, S, D)], "float32", seed=17)
    q, k, v = (x[:, :, :Hq].transpose(1, 2),
               x[:, :, Hq:Hq + Hkv].transpose(1, 2),
               x[:, :, Hq + Hkv:].transpose(1, 2))
    assert not q.is_contiguous()
    assert (q.data_ptr() % 16 != 0) == bool(offset)
    o, lse = k1_lib.forward_with_lse(q, k, v, causal=True, window=None)
    got = k1_lib.backward(q, k, v, o, lse, do, causal=True, window=None)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, flash_attention_ref(q, k, v),
                               **tolerance("float32"))
    want = flash_attention_bwd_ref(q, k, v, do, causal=True, window=None)
    for name, t, g, w in zip(("dq", "dk", "dv"), (q, k, v), got, want):
        assert g.shape == t.shape and bool(torch.isfinite(g).all()), name
        assert max_ratio(g, w) <= BACKWARD_LIMIT, name


@pytest.mark.cuda
def test_lse_is_the_rows_log_sum_exp(card):
    q, k, v = _inputs([(2, 14, 200, 64), (2, 2, 200, 64), (2, 2, 200, 64)],
                      "float32", seed=12)
    _, lse = k1_lib.forward_with_lse(q, k, v, causal=True, window=50)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(7, 1)) * 0.125
    i = torch.arange(200, device="cuda")
    keep = (i[:, None] >= i[None]) & (i[:, None] - i[None] < 50)
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_wrapper_gradient_comes_from_the_backward_kernel(card):
    """fp32 inputs that require grad: the output has a grad_fn, one forward
    (with the LSE) and one backward launch, gradients of the plain
    version's; in the model's strided [B, S, H, D] layout."""
    B, Hq, Hkv, S, D = 2, 14, 2, 130, 64
    (x,) = _inputs([(B, S, Hq + 2 * Hkv, D)], "float32", seed=13)
    (do,) = _inputs([(B, Hq, S, D)], "float32", seed=14)
    x.requires_grad_(True)
    q, k, v = (x[:, :, :Hq].transpose(1, 2),
               x[:, :, Hq:Hq + Hkv].transpose(1, 2),
               x[:, :, Hq + Hkv:].transpose(1, 2))
    n = _k1_counts()
    out = ops.flash_attention(q, k, v, impl="cuda")
    assert out.grad_fn is not None
    (gx,) = torch.autograd.grad(out, x, do)
    torch.cuda.synchronize()
    assert _k1_counts() == (n[0] + 1, n[1] + 1, n[2] + 1)
    xr = x.detach().clone().requires_grad_(True)
    out_r = ops.flash_attention(xr[:, :, :Hq].transpose(1, 2),
                                xr[:, :, Hq:Hq + Hkv].transpose(1, 2),
                                xr[:, :, Hq + Hkv:].transpose(1, 2),
                                impl="ref")
    (gr,) = torch.autograd.grad(out_r, xr, do)
    assert max_ratio(gx, gr) <= BACKWARD_LIMIT


def _bf16_counts():
    return (flash_attention.bf16_lse_launches,
            flash_attention.bf16_backward_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BACKWARD_BF16_CASES, ids=case_id)
def test_bf16_backward_kernel_matches_plain_version(card, case):
    """dq, dk, dv of csrc/flash_attention_bwd_bf16.cu against autograd
    through the plain attention on the same bf16 inputs, within
    BACKWARD_BF16_LIMIT of max |ref| and BACKWARD_BF16_RMS_LIMIT of its
    rms (a plain gradient that is exactly 0 within
    BACKWARD_BF16_ZERO_ATOL), twice with the same bits; the bf16 LSE entry
    point's output is the plain entry point's, bit for bit, and its LSE
    the rows' log-sum-exp."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v, do = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                           (B, Hq, S, D)], dtype, seed=18)
    n, nb = _k1_counts(), _bf16_counts()
    o, lse, o32 = k1_lib.forward_for_backward(q, k, v, causal=causal,
                                              window=window)
    o_plain = flash_attention(q, k, v, causal=causal, window=window)
    got = k1_lib.backward(q, k, v, o32, lse, do, causal=causal,
                          window=window)
    again = k1_lib.backward(q, k, v, o32, lse, do, causal=causal,
                            window=window)
    torch.cuda.synchronize()
    assert _k1_counts() == (n[0] + 2, n[1] + 1, n[2] + 2)
    assert _bf16_counts() == (nb[0] + 1, nb[1] + 2)
    assert torch.equal(o, o_plain) and o32.dtype == torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(Hq // Hkv, 1)) * D ** -0.5
    i = torch.arange(S, device="cuda")
    keep = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if causal:
        keep &= i[:, None] >= i[None]
    if window is not None:
        keep &= i[:, None] - i[None] < window
    want_lse = torch.logsumexp(s.masked_fill(~keep, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    want = flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
        assert g.shape == w.shape and g.dtype == torch.bfloat16, name
        assert bool(torch.isfinite(g.float()).all()), name
        assert bf16_backward_check(g, w)[2], (name, bf16_backward_check(g, w))
        assert torch.equal(g, g2), name


@pytest.mark.cuda
def test_kernels_raise_under_grad_on_card(card):
    """bf16 K1 under grad goes through its backward kernel: the gradient
    of flash_attention equals backward()'s on the LSE entry point's saved
    tensors, bit for bit, in the model's strided layout, and the bf16
    counters move.  K3 under grad gives outputs with a grad_fn, and its
    gradient comes from one launch of its backward kernel; under
    inference mode it gives none.  K2 is never differentiated: it raises
    when an input requires grad under grad mode, and runs under
    no_grad."""
    B, Hq, Hkv, S, D = 2, 14, 2, 130, 64
    (x,) = _inputs([(B, S, Hq + 2 * Hkv, D)], "bfloat16", seed=19)
    (do,) = _inputs([(B, Hq, S, D)], "bfloat16", seed=20)
    x.requires_grad_(True)
    q, k, v = (x[:, :, :Hq].transpose(1, 2),
               x[:, :, Hq:Hq + Hkv].transpose(1, 2),
               x[:, :, Hq + Hkv:].transpose(1, 2))
    n, nb = _k1_counts(), _bf16_counts()
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None and out.dtype == torch.bfloat16
    (gq, gk, gv) = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert _k1_counts() == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert _bf16_counts() == (nb[0] + 1, nb[1] + 1)
    with torch.no_grad():
        _, lse, o32 = k1_lib.forward_for_backward(q, k, v)
        want = k1_lib.backward(q, k, v, o32, lse, do)
    for g, w in zip((gq, gk, gv), want):
        assert torch.equal(g, w)
    with torch.no_grad():
        flash_attention(q, k, v)
    x, dt, Bm, Cm = _inputs([(1, 64, 4, 64), (1, 64, 4), (1, 64, 32),
                             (1, 64, 32)], "float32")
    A = -torch.ones(4, device="cuda", requires_grad=True)
    n3 = (ssd_scan.launches, ssd_scan.backward_launches)
    y, state = ssd_scan(x, torch.nn.functional.softplus(dt), A, Bm, Cm,
                        chunk=32)
    assert y.grad_fn is not None and state.grad_fn is not None
    (gA,) = torch.autograd.grad(y.sum(), A)
    torch.cuda.synchronize()
    assert gA.shape == A.shape and bool(torch.isfinite(gA).all())
    assert (ssd_scan.launches, ssd_scan.backward_launches) == (n3[0] + 1,
                                                               n3[1] + 1)
    with torch.inference_mode():
        y, _ = ssd_scan(x, torch.nn.functional.softplus(dt), A, Bm, Cm,
                        chunk=32)
    assert y.grad_fn is None
    qd, kd, vd = _inputs([(1, 4, 64), (1, 2, 128, 64), (1, 2, 128, 64)],
                         "float32")
    kd.requires_grad_(True)
    with pytest.raises(ValueError, match="not differentiable"):
        decode_attention(qd, kd, vd, 100)
    with torch.no_grad():
        decode_attention(qd, kd, vd, 100)


# dtype -> arch -> (loss rtol, each gradient leaf's rms error over its
# rms) of a train step on the card against the CPU.  fp32: both sum in fp32
# in different orders.  bf16: qwen2-0.5b's blocks run in bf16, which the
# card's products and the CPU's round at other places (the CPU tests'
# limits against JAX in bf16, tests/test_torch_training.py); hubert-xlarge's
# fp32 embeddings run its blocks in fp32, each leaf then rounded to bf16.
TRAIN_LIMITS = {"float32": {"qwen2-0.5b": (1e-5, 1e-4),
                            "hubert-xlarge": (1e-5, 1e-4)},
                "bfloat16": {"qwen2-0.5b": (2e-4, 5e-2),
                             "hubert-xlarge": (1e-5, 2.0 ** -8)}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hubert-xlarge"])
def test_train_step_on_card_matches_cpu(card, arch, dtype):
    """One train step's loss and gradients (K1 forward and backward, remat)
    on the card against the same step on the CPU (plain attention), with
    weights in fp32 or bf16: K1's launches are of the dtype the blocks run
    in (fp32 for hubert-xlarge's fp32 embeddings)."""
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.training.data import SyntheticEmbeds, SyntheticLM
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.train_loop import loss_and_grads, to_batch
    loss_rtol, grad_limit = TRAIN_LIMITS[dtype][arch]
    cfg = get_smoke_config(arch)
    params = Model(cfg).init_params(0, getattr(torch, dtype), device="cpu")
    data = (SyntheticEmbeds(cfg.d_model, cfg.vocab_size, 64, 2)
            if cfg.embedding_inputs else SyntheticLM(cfg.vocab_size, 64, 2))
    batch = data.batch_at(0)
    model = Model(cfg, remat=True)
    n, nb = _k1_counts(), _bf16_counts()
    (l_card, _), g_card = loss_and_grads(model, _to_card(params),
                                         to_batch(batch, torch.device("cuda")))
    torch.cuda.synchronize()
    blocks = cfg.num_blocks
    assert _k1_counts() == (n[0] + 2 * blocks, n[1] + blocks, n[2] + blocks)
    in_bf16 = dtype == "bfloat16" and not cfg.embedding_inputs
    assert _bf16_counts() == ((nb[0] + blocks, nb[1] + blocks) if in_bf16
                              else nb)
    (l_cpu, _), g_cpu = loss_and_grads(model, params,
                                       to_batch(batch, torch.device("cpu")))
    assert float(l_card) == pytest.approx(float(l_cpu), rel=loss_rtol)
    for a, b in zip(leaves(g_card), leaves(g_cpu)):
        assert a.dtype == b.dtype
        err = _rms(a.cpu().float() - b.float())
        assert err <= grad_limit * _rms(b) or err == 0.0
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
    from repro_torch.training import init_adamw
    p_card = _to_card(params)
    _, state, metrics = step(p_card, init_adamw(p_card),
                             to_batch(batch, torch.device("cuda")))
    assert int(state["count"]) == 1 and np.isfinite(float(metrics["loss"]))


# -- K3's backward kernel -----------------------------------------------------


def _ssd_bwd_inputs(case, seed: int, slow: bool) -> tuple:
    """A case's inputs (as _ssd_inputs), dy in its dtype and an fp32
    dstate."""
    b, S, H, P, N, chunk, dtype = case
    ins = _ssd_inputs(b, S, H, P, N, dtype, seed=seed, slow=slow)
    dy, dstate = _inputs([(b, S, H, P), (b, H, P, N)], "float32",
                         seed=seed + 1)
    return ins, dy.to(ins[0].dtype), dstate


@pytest.mark.cuda
@pytest.mark.parametrize("slow", [False, True], ids=["jax_dt", "slow_decay"])
@pytest.mark.parametrize("case", SSD_BACKWARD_CASES, ids=ssd_case_id)
def test_ssd_backward_kernel_matches_plain_version(card, case, slow):
    """dx, ddt, dA, dB and dC of csrc/ssd_scan_bwd.cu against autograd
    through the plain scan on the same inputs and cotangents, within the
    limits of cases.py, twice with the same bits (no atomics), one
    backward_launches count per call."""
    chunk, dtype = case[5], case[6]
    ins, dy, dstate = _ssd_bwd_inputs(case, seed=21, slow=slow)
    y, state, cs, states = k3_lib.forward_for_backward(*ins, chunk=chunk)
    n = ssd_scan.backward_launches
    got = k3_lib.backward(*ins, cs, states, dy, dstate, chunk=chunk)
    again = k3_lib.backward(*ins, cs, states, dy, dstate, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.backward_launches == n + 2
    want = ssd_scan_bwd_ref(*ins, dy, dstate)
    for name, t, g, w, g2 in zip(("dx", "ddt", "dA", "dB", "dC"), ins, got,
                                 want, again):
        assert g.shape == t.shape and g.dtype == t.dtype, name
        assert bool(torch.isfinite(g).all()), name
        assert ssd_backward_check(g, w, dtype)[2], (
            name, ssd_backward_check(g, w, dtype))
        assert torch.equal(g, g2), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [SSD_BACKWARD_TRAIN_CASE[:6],
                                   SSD_MAIN_CASE[:6]],
                         ids=["train", "four_chunks"])
def test_ssd_backward_da_on_slow_decay_at_chunk_256(card, shape, dtype):
    """dA, the gradient most exposed to the cancellation in dcs (each pair's
    s enters two positions with opposite signs, and da sums dcs over the
    chunk), on the slow-decay draw (decays near 1, so no term is damped)
    at mamba2-370m's chunk of 256 (four 64-key tiles, so each row's sum of
    s adds four tiles' partials): the training shape and four chunks of
    1024 tokens, within cases.py's limits, two calls bit-equal."""
    case = tuple(shape) + (dtype,)
    ins, dy, dstate = _ssd_bwd_inputs(case, seed=41, slow=True)
    _, _, cs, states = k3_lib.forward_for_backward(*ins, chunk=shape[5])
    got = k3_lib.backward(*ins, cs, states, dy, dstate, chunk=shape[5])[2]
    again = k3_lib.backward(*ins, cs, states, dy, dstate, chunk=shape[5])[2]
    want = ssd_scan_bwd_ref(*ins, dy, dstate)[2]
    assert ssd_backward_check(got, want, dtype)[2], ssd_backward_check(
        got, want, dtype)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_backward_takes_dy_that_cp_async_cannot_copy(card, dtype):
    """A dy whose base and row stride are not 16-byte aligned (a view one
    element into a wider tensor) gives the bits of its contiguous copy."""
    case = (2, 300, 4, 64, 32, 128, dtype)
    ins, dy, dstate = _ssd_bwd_inputs(case, seed=43, slow=True)
    wide = torch.zeros(dy.shape[:-1] + (dy.shape[-1] + 1,), dtype=dy.dtype,
                       device=dy.device)
    wide[..., 1:] = dy
    view = wide[..., 1:]
    assert view.stride(-1) == 1 and view.data_ptr() % 16
    _, _, cs, states = k3_lib.forward_for_backward(*ins, chunk=case[5])
    got = k3_lib.backward(*ins, cs, states, view, dstate, chunk=case[5])
    want = k3_lib.backward(*ins, cs, states, dy, dstate, chunk=case[5])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_wrapper_gradient_comes_from_the_backward_kernel(card, dtype):
    """Inputs that require grad in the model's layout (x, B and C views
    into one conv output): ssd_scan's outputs have a grad_fn, one forward
    and one backward launch, and autograd's gradients, through y and the
    final state, are the backward kernel's own output bit for bit."""
    b, S, H, P, N, chunk = 2, 300, 4, 64, 32, 128
    (xbc,) = _inputs([(b, S, H * P + 2 * N)], dtype, seed=31)
    _, dt, A, _, _ = _ssd_inputs(b, S, H, P, N, dtype, seed=32, slow=True)
    dy, dstate = _inputs([(b, S, H, P), (b, H, P, N)], "float32", seed=33)
    dy = dy.to(xbc.dtype)

    def split(t):
        return (t[..., :H * P].reshape(b, S, H, P), t[..., H * P:H * P + N],
                t[..., H * P + N:])

    leaves = [t.clone().requires_grad_(True) for t in (xbc, dt, A)]
    x, B, C = split(leaves[0])
    n = (ssd_scan.launches, ssd_scan.backward_launches)
    y, state = ops.ssd_scan(x, leaves[1], leaves[2], B, C, chunk=chunk,
                            impl="cuda")
    assert y.grad_fn is not None and state.grad_fn is not None
    gxbc, gdt, gA = torch.autograd.grad((y, state), leaves, (dy, dstate))
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.backward_launches) == (n[0] + 1,
                                                               n[1] + 1)
    x, B, C = split(xbc)
    _, _, cs, states = k3_lib.forward_for_backward(x, dt, A, B, C,
                                                   chunk=chunk)
    dx, ddt, dA, dB, dC = k3_lib.backward(x, dt, A, B, C, cs, states, dy,
                                          dstate, chunk=chunk)
    assert torch.equal(gxbc, torch.cat([dx.reshape(b, S, H * P), dB, dC],
                                       dim=-1))
    assert torch.equal(gdt, ddt) and torch.equal(gA, dA)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_ssd_gradient_under_remat_is_the_plain_runs(card, arch):
    """A Mamba2 model's loss and block gradients with remat (each
    checkpointed block run twice: the backward reads the scratch of the
    recomputation) equal those without, bit for bit; K3 launches its
    forward twice per Mamba2 sublayer with remat and once without, its
    backward once either way.  (The token table's gradient, an indexed
    sum outside the blocks, is left out.)"""
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.train_loop import loss_and_grads, to_batch
    cfg = get_smoke_config(arch)
    params = Model(cfg).init_params(0, torch.float32, device="cuda")
    batch = to_batch(SyntheticLM(cfg.vocab_size, 96, 2).batch_at(0),
                     torch.device("cuda"))
    subs = cfg.layer_pattern.count("mamba") * cfg.num_blocks
    runs = {}
    for remat in (True, False):
        n = (ssd_scan.launches, ssd_scan.backward_launches)
        (loss, _), grads = loss_and_grads(Model(cfg, remat=remat), params,
                                          batch)
        torch.cuda.synchronize()
        assert (ssd_scan.launches - n[0], ssd_scan.backward_launches - n[1]
                ) == ((2 if remat else 1) * subs, subs)
        runs[remat] = (loss, leaves(grads["blocks"]))
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)


# dtype -> (loss rtol, each gradient leaf's rms error over its rms) of a
# Mamba2 family's train step with the kernels against the same step with
# the plain versions on the card: chip_smoke's 13b (fp32) and 13e (bf16)
# limits.  In bf16 a leaf may also differ by as much as the plain
# version's own bf16 gradient differs from its fp32 one there: jamba's
# leaves read up to 0.26 so, 123 of 135 above 5e-2 (chip_smoke 13c on an
# NVIDIA H100 80GB HBM3 at 700 W).
MAMBA_TRAIN_LIMITS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-4, 5e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_mamba_train_step_on_card_matches_plain_path(card, arch, dtype):
    """One train step's loss and gradients with remat on the card with the
    kernels (K3's forward and backward) against the plain versions (the
    token recurrence), at smoke width in fp32 and bf16."""
    from repro_torch.training.checkpoint import flatten
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.train_loop import loss_and_grads, to_batch
    loss_rtol, grad_limit = MAMBA_TRAIN_LIMITS[dtype]
    cfg = get_smoke_config(arch)
    params = Model(cfg).init_params(0, getattr(torch, dtype), device="cuda")
    batch = to_batch(SyntheticLM(cfg.vocab_size, 64, 2).batch_at(0),
                     torch.device("cuda"))
    model = Model(cfg, remat=True)
    n = ssd_scan.backward_launches
    (loss, _), grads = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    assert ssd_scan.backward_launches == n + cfg.layer_pattern.count(
        "mamba") * cfg.num_blocks
    (loss_ref, _), grads_ref = loss_and_grads(model, params, batch,
                                              impl="ref")
    floor = {}
    if dtype == "bfloat16":
        _, grads_32 = loss_and_grads(model, _widened(params), batch,
                                     impl="ref")
        floor = {k: _rms(w.float() - w32) / _rms(w32) for (k, w), w32 in
                 zip(flatten(grads_ref).items(), flatten(grads_32).values())}
    assert float(loss) == pytest.approx(float(loss_ref), rel=loss_rtol)
    for (k, g), w in zip(flatten(grads).items(), flatten(grads_ref).values()):
        assert g.dtype == w.dtype
        err = _rms(g.float() - w.float())
        assert err <= max(grad_limit, floor.get(k, 0.0)) * _rms(w) or (
            err == 0.0), k


def _spmd_card_rank(rank, cfg, params, inputs, config, cap):
    """One of two gloo ranks on the card: its stage of ``config`` through
    the GPipe schedule (spawned by ``spawn_ranks``)."""
    from repro_torch.launch.mesh import make_stage_mesh
    from repro_torch.pipeline.spmd import make_pipeline_fn, stage_tile
    mesh = make_stage_mesh(2, device="cuda:0")
    fn = make_pipeline_fn(cfg, mesh, num_microbatches=inputs.shape[0],
                          cap=cap)
    tile = stage_tile(params["blocks"], config, cap, mesh.axis_index("stage"))
    n = flash_attention.tensor_core_launches
    out = fn(tile, config, inputs)
    torch.cuda.synchronize()
    return dict(out=out.float().cpu().numpy(), device=str(mesh.device),
                launches=flash_attention.tensor_core_launches - n,
                sends=fn.sends, host_copies=fn.host_copies)


@pytest.mark.cuda
@pytest.mark.parametrize("config", [[1, 3], [4, 0]], ids=str)
def test_spmd_pipeline_under_gloo_on_card(card, tmp_path, config):
    """Two gloo ranks on one card at smoke width (bf16, K1 on its
    tensor-core kernel): the pipeline's outputs bit-equal to the blocks
    run in order in this process, every CUDA hand-off and the final
    broadcast through a host buffer (gloo's point-to-point ops take CPU
    tensors only)."""
    import dataclasses

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.layers import embed
    from repro_torch.pipeline import LocalPipelineExecutor
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), num_layers=4)
    params = Model(cfg).init_params(0, dtype=torch.bfloat16, device="cuda")
    M, S = 2, 128
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (M, 1, S)), device="cuda")
    with torch.no_grad():
        inputs = embed(params["embed"], tokens)
    ex = LocalPipelineExecutor(cfg, params, device="cuda")
    pos = torch.arange(S, device="cuda").expand(1, S)
    ref = torch.stack([ex.stage_fn(inputs[m], pos, 0, cfg.num_blocks)
                       for m in range(M)]).float().cpu().numpy()
    ranks = spawn_ranks(_spmd_card_rank, 2,
                        (cfg, params, inputs, config, 4), backend="gloo",
                        init_file=str(tmp_path / "rendezvous"))
    for rank, r in enumerate(ranks):
        assert r["device"] == "cuda:0"
        assert np.array_equal(r["out"], ref)
        assert r["launches"] == config[rank] * M
    # Rank 0 sends M activations (M host copies) and receives the
    # broadcast (1); rank 1 receives M (M) and sends the broadcast (2).
    assert [r["sends"] for r in ranks] == [M, 0]
    assert [r["host_copies"] for r in ranks] == [M + 1, M + 2]
