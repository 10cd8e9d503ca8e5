"""The port's kernels (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode and its jnp oracles: flash
attention (K1), decode attention (K2) and the SSD scan (K3)."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models.attention import flash_attention_jnp  # noqa: E402
from repro.models import mamba2 as jax_mamba  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    NSPLIT,
    decode_attention,
    split_ranges,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    decode_attention_ref,
    flash_attention_bwd_ref,
    flash_attention_ref,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)
from repro_torch.kernels import ssd_scan as k3_lib  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import mamba2 as port_mamba  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    BACKWARD_BF16_CASES,
    BACKWARD_BF16_LIMIT,
    BACKWARD_BF16_RMS_LIMIT,
    BACKWARD_BF16_TRAIN_CASE,
    BACKWARD_CASES,
    BACKWARD_LIMIT,
    BACKWARD_TRAIN_CASE,
    DECODE_CASES,
    DECODE_CORNER_CASES,
    DECODE_FAMILY_MAIN_CASES,
    DECODE_MAIN_CASE,
    DECODE_MAIN_RMS_LIMIT,
    DECODE_MAIN_TOLERANCE,
    DECODE_RAGGED_CASES,
    FAMILY_MAIN_CASES,
    FLASH_CASES,
    MAIN_RMS_LIMIT,
    MAIN_TOLERANCE,
    RAGGED_CASES,
    SSD_BACKWARD_CASES,
    SSD_BACKWARD_LIMIT,
    SSD_BACKWARD_SMOKE_CASE,
    SSD_BACKWARD_TIMED,
    SSD_BACKWARD_TRAIN_CASE,
    SSD_CASES,
    SSD_CORNER_CASES,
    SSD_FAMILY_MAIN_CASES,
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

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# The slow interpret-mode comparison runs on these cases; the rest use the
# ref.
INTERPRET = {1, 3, 5, 6}
DECODE_INTERPRET = {2, 3}
SSD_INTERPRET = {1, 3}


def _inputs(B, Hq, Hkv, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("case", range(len(FLASH_CASES)),
                         ids=[case_id(c) for c in FLASH_CASES])
def test_flash_attention_matches_jax(case):
    B, Hq, Hkv, S, D, causal, window, dtype = FLASH_CASES[case]
    (jq, jk, jv), (q, k, v) = _inputs(B, Hq, Hkv, S, D, dtype)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    got = out.float().numpy()
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **tolerance(dtype))
    if case in INTERPRET:
        pallas = jax_ops.flash_attention(jq, jk, jv, causal=causal,
                                         window=window, impl="interpret",
                                         block_q=64, block_k=64)
        np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                                   **tolerance(dtype))


@pytest.mark.parametrize("case", RAGGED_CASES + TENSOR_CORE_CASES,
                         ids=case_id)
def test_flash_attention_ragged_sequence(case):
    """S not a multiple of 64, and the bf16 shapes that reach the corners
    of the tensor-core kernel (padded head dims, S below one tile, group 7,
    a narrow window, a ragged bidirectional S)."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(B, Hq, Hkv, S, D, dtype, seed=1)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tolerance(dtype))


def _tensor_core_emulation(q, k, v, split: bool, block_k: int = 128):
    """The rounding of the bf16 tensor-core kernel, on the CPU: 128-key
    tiles, online softmax in fp32, bf16 products summed in fp32, and P
    split into bf16 hi = bf16(P) and lo = bf16(P - hi) for P V (with
    ``split`` False, P in bf16 alone).  l is summed from the fp32 P.
    Causal, q [B, Hq, S, D], k/v [B, Hkv, S, D] -> bf16."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    m = torch.full((B, Hq, S, 1), -1e30)
    l = torch.zeros((B, Hq, S, 1))
    acc = torch.zeros((B, Hq, S, D))
    qp = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        kp = torch.arange(k0, min(k0 + block_k, S))[None, :]
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) * D ** -0.5
        s = torch.where(qp >= kp, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        tile_v = vf[:, :, k0:k0 + block_k]
        pv = hi @ tile_v
        if split:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ tile_v
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("split", [True, False], ids=["hi_lo", "bf16_p"])
def test_tensor_core_rounding_meets_main_limits_only_with_split_p(split):
    """At the main path's S and D, the tensor-core kernel's rounding with P
    split into bf16 hi and lo passes MAIN_TOLERANCE and MAIN_RMS_LIMIT
    against the JAX oracle; with P rounded to bf16 alone it fails the rms
    limit (about 2e-3 of rms(ref), ten times the limit)."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 4, 2, 1024, 128, "bfloat16", seed=5)
    got = _tensor_core_emulation(q, k, v, split).float().numpy()
    want = np.asarray(jax_ref.flash_attention_ref(jq, jk, jv), np.float32)
    d = got - want
    elementwise = bool(np.all(np.abs(d) <= MAIN_TOLERANCE["atol"]
                              + MAIN_TOLERANCE["rtol"] * np.abs(want)))
    rms_ratio = np.sqrt(np.mean(d ** 2)) / np.sqrt(np.mean(want ** 2))
    if split:
        assert elementwise and rms_ratio <= MAIN_RMS_LIMIT
    else:
        assert rms_ratio > MAIN_RMS_LIMIT


def test_strided_model_layout_matches_contiguous():
    """The model hands over [B, S, H, D] projections transposed in place;
    the result must not depend on the layout."""
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 96, 64, "float32", seed=2)
    qs, ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    assert not qs.is_contiguous()
    torch.testing.assert_close(ops.flash_attention(qs, ks, vs),
                               ops.flash_attention(q, k, v),
                               atol=0.0, rtol=0.0)


def test_cuda_impl_on_cpu_raises():
    (_, _, _), (q, k, v) = _inputs(1, 2, 2, 64, 64, "float32")
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    assert flash_attention.launches == launches


def test_wrapper_takes_plain_version_on_cpu():
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 64, 64, "float32", seed=3)
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=16)
    torch.testing.assert_close(
        out, flash_attention_ref(q, k, v, causal=True, window=16),
        atol=0.0, rtol=0.0)
    assert flash_attention.launches == launches   # no kernel ran


@pytest.mark.parametrize("bad", ["shape", "heads", "window",
                                 "bf16_head_dim", "head_dim"])
def test_wrapper_rejects_bad_inputs(bad):
    """Shapes neither kernel takes are refused on every device: among them
    a bf16 head dim that is not a multiple of 8 (TMA's 16-byte stride
    rule) and one above 128."""
    D = {"bf16_head_dim": 60, "head_dim": 136}.get(bad, 64)
    dtype = "bfloat16" if bad == "bf16_head_dim" else "float32"
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 64, D, dtype)
    if bad == "shape":
        k = k[:, :, :32]
    elif bad == "heads":
        q = q[:, :3]
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0 if bad == "window" else None)


# ---------------------------------------------------------------------------
# decode attention (K2)
# ---------------------------------------------------------------------------


def _decode_inputs(B, Hq, Hkv, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, D), (B, Hkv, S, D), (B, Hkv, S, D))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


@pytest.mark.parametrize("case", range(len(DECODE_CASES)),
                         ids=[decode_case_id(c) for c in DECODE_CASES])
def test_decode_attention_matches_jax(case):
    B, Hq, Hkv, S, D, idx, window, dtype = DECODE_CASES[case]
    (jq, jk, jv), (q, k, v) = _decode_inputs(B, Hq, Hkv, S, D, dtype)
    out = ops.decode_attention(q, k, v, idx, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    got = out.float().numpy()
    want = jax_ref.decode_attention_ref(jq, jk, jv, idx, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **tolerance(dtype))
    if case in DECODE_INTERPRET:
        pallas = jax_ops.decode_attention(jq, jk, jv, jnp.int32(idx),
                                          window=window, impl="interpret",
                                          block_k=128)
        np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                                   **tolerance(dtype))


@pytest.mark.parametrize("case", DECODE_RAGGED_CASES + DECODE_CORNER_CASES
                         + [DECODE_MAIN_CASE], ids=decode_case_id)
def test_decode_attention_ragged_and_main_shapes(case):
    B, Hq, Hkv, S, D, idx, window, dtype = case
    (jq, jk, jv), (q, k, v) = _decode_inputs(B, Hq, Hkv, S, D, dtype, seed=1)
    got = ops.decode_attention(q, k, v, idx, window=window).float().numpy()
    want = np.asarray(jax_ref.decode_attention_ref(jq, jk, jv, idx,
                                                   window=window), np.float32)
    main = case == DECODE_MAIN_CASE
    np.testing.assert_allclose(
        got, want, **(DECODE_MAIN_TOLERANCE if main else tolerance(dtype)))
    if main:
        rms_err = np.sqrt(np.mean(np.square(got - want)))
        assert rms_err <= DECODE_MAIN_RMS_LIMIT * np.sqrt(
            np.mean(np.square(want)))


def test_decode_ignores_stale_cache_beyond_index():
    """Slots past `index` must not leak into the output."""
    (_, _, _), (q, k, v) = _decode_inputs(1, 4, 2, 256, 64, "float32")
    out1 = ops.decode_attention(q, k, v, 100)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 101:] = 99.0
    v2[:, :, 101:] = -99.0
    out2 = ops.decode_attention(q, k2, v2, 100)
    torch.testing.assert_close(out1, out2, atol=1e-6, rtol=0.0)


def test_decode_reads_model_cache_layout_and_tensor_index():
    """The model's [B, S, Hkv, D] cache read through strides, and a 0-d
    int32 index, give what a contiguous cache and an int give."""
    (_, _, _), (q, k, v) = _decode_inputs(2, 8, 2, 96, 64, "float32", seed=2)
    ks, vs = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))
    assert not ks.is_contiguous()
    idx = torch.tensor(70, dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(q, ks, vs, idx, window=40),
                               ops.decode_attention(q, k, v, 70, window=40),
                               atol=0.0, rtol=0.0)


@pytest.mark.parametrize("index,S,window", [
    (1040, 2048, None), (0, 256, None), (255, 256, None), (5, 2048, None),
    (1500, 2048, 40), (70, 96, 40), (3000, 2048, None), (0, 1, None)])
def test_decode_splits_cover_the_cache(index, S, window):
    """The kernel's rule: the live slots [max(0, index - window + 1),
    min(index, S - 1)] are cut into ``nsplit`` shares of equal length (the
    last ones shorter or empty), which together hold each live slot once,
    in order; at the main shape every block of a cluster has work."""
    lo = max(0, index - window + 1) if window else 0
    hi = min(index, S - 1)
    for nsplit in (1, 8, NSPLIT):
        ranges = split_ranges(index, S, window, nsplit)
        assert len(ranges) == nsplit
        assert [p for a, b in ranges for p in range(a, b)] == list(
            range(lo, hi + 1))
        share = -(-(hi - lo + 1) // nsplit)
        assert all(b - a <= share for a, b in ranges)
    _, _, _, S, _, index, window, _ = DECODE_MAIN_CASE
    assert all(b - a > 0 for a, b in split_ranges(index, S, window))


def _decode_split_emulation(q, k, v, index, window, dtype=torch.float64):
    """The kernel's arithmetic on the CPU: the live slots in NSPLIT shares
    (``split_ranges``); each share in passes of at most 64 KB of K and V,
    with an online softmax (m starting at -1e30); the shares merged as the
    cluster merges them, the normaliser floored at 1e-30; all of it in
    ``dtype`` (the kernel's fp64), rounded to fp32 and then to q's dtype.
    q [B, Hq, D], k/v [B, Hkv, S, D] -> q's dtype."""
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    cap = min(-(-S // NSPLIT), 65536 // (2 * D * q.element_size()))
    qf = q.to(dtype).reshape(B, Hkv, G, D)
    kf, vf = k.to(dtype), v.to(dtype)
    parts = []
    for s0, s1 in split_ranges(index, S, window):
        m = torch.full((B, Hkv, G, 1), -1e30, dtype=dtype)
        l = torch.zeros((B, Hkv, G, 1), dtype=dtype)
        acc = torch.zeros((B, Hkv, G, D), dtype=dtype)
        for p0 in range(s0, s1, cap):
            p1 = min(p0 + cap, s1)
            sc = torch.einsum("bhgd,bhkd->bhgk", qf, kf[:, :, p0:p1]) \
                * D ** -0.5
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, p0:p1]
            m = m_new
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = sum(torch.exp(m - M) * l for m, l, _ in parts)
    out = sum(torch.exp(m - M) * acc for m, _, acc in parts)
    return (out / L.clamp_min(1e-30)).reshape(B, Hq, D).float().to(q.dtype)


@pytest.mark.parametrize("case", DECODE_CASES + DECODE_RAGGED_CASES
                         + DECODE_CORNER_CASES + [DECODE_MAIN_CASE],
                         ids=decode_case_id)
def test_decode_split_and_merge_emulation_matches_plain_version(case):
    """The kernel's split of the live slots by ``index`` and its merge,
    emulated in fp64 as the kernel runs it, against the plain version (at
    the main shape at DECODE_MAIN_TOLERANCE and DECODE_MAIN_RMS_LIMIT)."""
    B, Hq, Hkv, S, D, idx, window, dtype = case
    (_, _, _), (q, k, v) = _decode_inputs(B, Hq, Hkv, S, D, dtype, seed=6)
    got = _decode_split_emulation(q, k, v, idx, window).float()
    want = decode_attention_ref(q, k, v, idx, window=window).float()
    if case == DECODE_MAIN_CASE:
        torch.testing.assert_close(got, want, **DECODE_MAIN_TOLERANCE)
        assert float((got - want).square().mean().sqrt()) <= \
            DECODE_MAIN_RMS_LIMIT * float(want.square().mean().sqrt())
    else:
        torch.testing.assert_close(got, want, **tolerance(dtype))


def _decode_main_rms(seed: int, dtype) -> float:
    """rms error over rms ref of the split emulation in ``dtype`` at
    DECODE_MAIN_CASE on draw ``seed``, after checking
    DECODE_MAIN_TOLERANCE."""
    B, Hq, Hkv, S, D, idx, window, in_dtype = DECODE_MAIN_CASE
    (_, _, _), (q, k, v) = _decode_inputs(B, Hq, Hkv, S, D, in_dtype,
                                          seed=seed)
    got = _decode_split_emulation(q, k, v, idx, window, dtype).float()
    want = decode_attention_ref(q, k, v, idx, window=window).float()
    torch.testing.assert_close(got, want, **DECODE_MAIN_TOLERANCE)
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt())


@pytest.mark.parametrize("seed", range(6))
def test_decode_main_case_emulation_holds_over_draws(seed):
    """The kernel's fp64 arithmetic meets DECODE_MAIN_RMS_LIMIT on every
    draw, not on a lucky one."""
    assert _decode_main_rms(seed, torch.float64) <= DECODE_MAIN_RMS_LIMIT


def test_decode_main_rms_limit_breaks_fp32_arithmetic_on_some_draw():
    """In fp32 the same split and merge round a bf16 output one ulp away
    from the plain version's on some draws, which alone reads an rms over
    DECODE_MAIN_RMS_LIMIT: the reason the kernel computes in fp64."""
    readings = [_decode_main_rms(seed, torch.float32) for seed in range(12)]
    assert max(readings) > DECODE_MAIN_RMS_LIMIT


# ---------------------------------------------------------------------------
# SSD scan (K3)
# ---------------------------------------------------------------------------


def _ssd_inputs(b, S, H, P, N, dtype, seed=0):
    """x, dt (softplus), A (negative), B, C as numpy fp32, then as the JAX
    and port arrays in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, S, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32)
    C = rng.standard_normal((b, S, N)).astype(np.float32)
    arrs = (x, dt, A, B, C)
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs], arrs)


@pytest.mark.parametrize("case", range(len(SSD_CASES)),
                         ids=[ssd_case_id(c) for c in SSD_CASES])
def test_ssd_scan_matches_jax(case):
    b, S, H, P, N, chunk, dtype = SSD_CASES[case]
    jin, tin, raw = _ssd_inputs(b, S, H, P, N, dtype)
    y, state = ops.ssd_scan(*tin, chunk=chunk)
    assert y.dtype == tin[0].dtype and y.shape == tin[0].shape
    assert state.dtype == torch.float32 and state.shape == (b, H, P, N)
    # The JAX oracle takes A in fp32, as the JAX test hands it over.
    want = jax_ref.ssd_scan_ref(jin[0], jin[1], jnp.asarray(raw[2]), *jin[3:])
    assert max_ratio(y.float().numpy(), want) < ssd_limit(dtype)
    if case in SSD_INTERPRET:
        # The Pallas kernel's head block (a layout knob K3 does not have)
        # as the JAX package's cases give it for these shapes.
        pallas = jax_ops.ssd_scan(*jin, chunk=chunk, block_h=min(H, 8),
                                  impl="interpret")
        assert max_ratio(y.float().numpy(), pallas) < ssd_limit(dtype)


@pytest.mark.parametrize("case", SSD_RAGGED_CASES + SSD_CORNER_CASES,
                         ids=ssd_case_id)
def test_ssd_scan_ragged_sequence(case):
    b, S, H, P, N, chunk, dtype = case
    jin, tin, raw = _ssd_inputs(b, S, H, P, N, dtype, seed=1)
    y, _ = ssd_scan(*tin, chunk=chunk)
    want = jax_ref.ssd_scan_ref(jin[0], jin[1], jnp.asarray(raw[2]), *jin[3:])
    assert max_ratio(y.float().numpy(), want) < ssd_limit(dtype)


def test_ssd_final_state_matches_model_chunked_form():
    """y and the final state == models.mamba2.ssd_chunked's (the tolerance
    of the JAX kernel test against the chunked form)."""
    b, S, H, P, N = 2, 256, 8, 64, 32
    jin, tin, _ = _ssd_inputs(b, S, H, P, N, "float32", seed=3)
    y, state = ops.ssd_scan(*tin, chunk=64)
    y_model, s_model = jax_mamba.ssd_chunked(*jin, chunk=64)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_model),
                               atol=5e-4, rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_model),
                               atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel", ["decode_attention", "ssd_scan"])
def test_cuda_impl_on_cpu_raises_for_every_kernel(kernel):
    if kernel == "decode_attention":
        (_, _, _), args = _decode_inputs(1, 2, 2, 64, 64, "float32")
        args = (*args, 10)
        wrapper, call = decode_attention, ops.decode_attention
    else:
        _, args, _ = _ssd_inputs(1, 32, 2, 8, 8, "float32")
        wrapper, call = ssd_scan, ops.ssd_scan
    launches = (decode_attention.launches, ssd_scan.launches)
    with pytest.raises(ValueError, match="CUDA"):
        call(*args, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        call(*args, impl="pallas")
    wrapper(*args)                       # the plain version: no launch
    assert (decode_attention.launches, ssd_scan.launches) == launches


@pytest.mark.parametrize("bad", ["q", "kv", "heads", "window",
                                 "bf16_head_dim", "head_dim"])
def test_decode_wrapper_rejects_bad_inputs(bad):
    """Among the shapes refused on every device: a bf16 head dim that is
    not a multiple of 8 (16-byte copies) and one above 128."""
    D = {"bf16_head_dim": 60, "head_dim": 136}.get(bad, 64)
    dtype = "bfloat16" if bad == "bf16_head_dim" else "float32"
    (_, _, _), (q, k, v) = _decode_inputs(1, 4, 2, 64, D, dtype)
    if bad == "q":
        q = q[:, :, None]
    elif bad == "kv":
        v = v[:, :, :32]
    elif bad == "heads":
        q = q[:, :3]
    with pytest.raises(ValueError):
        decode_attention(q, k, v, 10, window=0 if bad == "window" else None)


@pytest.mark.parametrize("bad", ["dt", "A", "C", "chunk"])
def test_ssd_wrapper_rejects_bad_inputs(bad):
    _, (x, dt, A, B, C), _ = _ssd_inputs(1, 32, 2, 8, 8, "float32")
    if bad == "dt":
        dt = dt[:, :16]
    elif bad == "A":
        A = A[:1]
    elif bad == "C":
        C = C[..., :4]
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, B, C, chunk=0 if bad == "chunk" else 16)


@pytest.mark.parametrize("slow", [False, True], ids=["jax_dt", "slow_decay"])
def test_ssd_main_limits_catch_a_wrong_carry(slow):
    """At the main path's shape the model's chunked form, in fp32 with y
    rounded to bf16, passes SSD_MAIN_TOLERANCE and SSD_MAIN_RMS_LIMIT
    against the plain scan; with the state carried across chunks scaled by
    0.99 it fails them, though it passes the JAX bf16 limit."""
    b, S, H, P, N, chunk, dtype = SSD_MAIN_CASE
    _, tin, _ = _ssd_inputs(b, S, H, P, N, dtype, seed=4)
    if slow:   # dt log-uniform in [1e-3, 1e-1]: the state carries far
        rng = np.random.default_rng(5)
        tin[1] = torch.from_numpy(np.exp(rng.uniform(
            np.log(1e-3), np.log(1e-1), (b, S, H))).astype(np.float32)).to(
                tin[1].dtype)
    want, _ = ssd_scan(*tin, chunk=chunk)
    x, dt, A, B, C = (t.float() for t in tin)

    def chunked(carry: float):
        state, ys = None, []
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            y, state = port_mamba.ssd_chunked(
                x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], chunk=chunk,
                init_state=None if state is None else carry * state)
            ys.append(y.to(want.dtype))
        return torch.cat(ys, dim=1).float()

    def passes(got) -> bool:
        ref, tol = want.float(), SSD_MAIN_TOLERANCE
        d = got - ref
        return (bool((d.abs() <= tol["atol"] + tol["rtol"] * ref.abs()).all())
                and float(d.square().mean().sqrt())
                <= SSD_MAIN_RMS_LIMIT * float(ref.square().mean().sqrt()))

    assert passes(chunked(1.0))
    wrong = chunked(0.99)
    assert max_ratio(wrong, want) < ssd_limit(dtype) and not passes(wrong)


def _bf16_terms(t: torch.Tensor, terms: int) -> torch.Tensor:
    """fp32 ``t`` as the sum of ``terms`` bf16 values: bf16(t), then
    bf16 of what is left, ..."""
    out, rest = torch.zeros_like(t), t
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part, rest - part
    return out


def _ssd_tensor_core_emulation(x, dt, A, B, C, chunk: int, terms: int = 3,
                               tf32: bool = False):
    """The chunk-parallel kernel's order and rounding on the CPU: per chunk
    the cumulative dA (summed in fp64, kept as an fp32 hi + lo pair), the
    chunk's own state, the recurrence over chunks in fp32, and the outputs.
    bf16 route: C . B^T exact in fp32; the decay-weighted scores,
    exp(cs_last - cs_j) dt_j x_j and the entering state h, the fp32
    operands of its products, as ``terms`` bf16 terms (the kernel uses 3).
    fp32 route (``tf32``): every product over k-slices of 8 in order, in
    ``terms`` TF32 products each (``_split_matmul``; the kernel uses 3).
    Returns (y in x's dtype, the fp32 final state)."""
    b, S, H, P = x.shape
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))
    h = torch.zeros((b, H, P, B.shape[-1]))

    def mm(a, m, fp32_operand: str):
        """a @ m; on the bf16 route the operand named (a or m) in bf16
        terms."""
        if tf32:
            return _split_matmul(a, m, terms)
        if fp32_operand == "a":
            a = _bf16_terms(a, terms)
        elif fp32_operand == "m":
            m = _bf16_terms(m, terms)
        return a @ m

    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        cl = sl.stop - c0
        d = dtf[:, sl]                                       # [b, cl, H]
        cs = torch.cumsum((d * Af).double(), dim=1)          # in fp64,
        hi = cs.float()                                      # kept as
        lo = (cs - hi.double()).float()                      # hi + lo
        w = torch.exp((hi[:, -1:] - hi) + (lo[:, -1:] - lo)) * d
        xc = xf[:, sl].permute(0, 2, 1, 3)                   # [b, H, cl, P]
        own = mm((xc * w.transpose(1, 2)[..., None]).transpose(-1, -2),
                 Bf[:, sl, None].transpose(1, 2), "a")       # [b, H, P, N]
        scores = mm(Cf[:, sl], Bf[:, sl].transpose(-1, -2), "")
        live = torch.tril(torch.ones((cl, cl), dtype=torch.bool))
        decay = torch.exp((hi[:, :, None] - hi[:, None])
                          + (lo[:, :, None] - lo[:, None])) * d[:, None]
        weighted = torch.where(live[None, :, :, None],
                               scores[..., None] * decay, torch.zeros(()))
        y = mm(weighted.permute(0, 3, 1, 2), xc, "a")         # [b, H, cl, P]
        y = y + torch.exp(hi + lo).transpose(1, 2)[..., None] * mm(
            Cf[:, None, sl], h.transpose(-1, -2), "m")
        h = torch.exp(hi[:, -1] + lo[:, -1])[..., None, None] * h + own
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1).to(x.dtype), h


@functools.lru_cache(maxsize=None)
def _ssd_case(case, seed: int, slow: bool = False) -> tuple:
    """Inputs of an SSD case (as ``_ssd_inputs``; with ``slow``, dt
    log-uniform in [1e-3, 1e-1]) and the plain scan's y and state."""
    b, S, H, P, N, chunk, dtype = case
    jin, tin, raw = _ssd_inputs(b, S, H, P, N, dtype, seed)
    if slow:
        rng = np.random.default_rng(seed + 1)
        tin[1] = torch.from_numpy(np.exp(rng.uniform(
            np.log(1e-3), np.log(1e-1), (b, S, H))).astype(np.float32)).to(
                tin[1].dtype)
    return jin, tin, raw, ssd_scan_ref(*tin)


def _rms_ratio(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt())


@pytest.mark.parametrize("slow", [False, True], ids=["jax_dt", "slow_decay"])
@pytest.mark.parametrize("terms", [3, 2, 1],
                         ids=["three_terms", "hi_lo", "bf16"])
def test_ssd_tensor_core_rounding_meets_main_limits_only_with_split(terms,
                                                                    slow):
    """At the main shape the kernel's rounding (fp32 operands in three bf16
    terms) passes SSD_MAIN_TOLERANCE, SSD_MAIN_RMS_LIMIT and
    SSD_STATE_RMS_LIMIT against the plain scan; hi + lo passes with less
    room (y is rounded to bf16, which turns a relative difference d into
    roundings flipped at an rms of about sqrt(d) ulp); the fp32 operands
    rounded to bf16 alone fail both rms limits.  ``pytest -s`` prints the
    readings."""
    *_, chunk, _ = SSD_MAIN_CASE
    _, tin, _, (y_ref, s_ref) = _ssd_case(SSD_MAIN_CASE, 4, slow)
    y, state = _ssd_tensor_core_emulation(*tin, chunk, terms)
    y_rms, s_rms = _rms_ratio(y, y_ref), _rms_ratio(state, s_ref)
    atol = float(((y.float() - y_ref.float()).abs()
                  - SSD_MAIN_TOLERANCE["rtol"] * y_ref.float().abs()).max())
    print(f"K3 emulation, {terms} bf16 terms, {'slow' if slow else 'JAX'} "
          f"dt: y rms {y_rms:.3e} (limit {SSD_MAIN_RMS_LIMIT}), least atol "
          f"{atol:.3e} (limit {SSD_MAIN_TOLERANCE['atol']}), state rms "
          f"{s_rms:.3e} (limit {SSD_STATE_RMS_LIMIT})")
    if terms > 1:
        torch.testing.assert_close(y.float(), y_ref.float(),
                                   **SSD_MAIN_TOLERANCE)
        assert y_rms <= SSD_MAIN_RMS_LIMIT and s_rms <= SSD_STATE_RMS_LIMIT
    else:
        assert y_rms > SSD_MAIN_RMS_LIMIT and s_rms > SSD_STATE_RMS_LIMIT


@pytest.mark.parametrize("case", SSD_CASES + SSD_RAGGED_CASES
                         + SSD_CORNER_CASES, ids=ssd_case_id)
def test_ssd_tensor_core_emulation_matches_jax(case):
    """The chunk-parallel order with the kernel's rounding, at the case's
    own chunk (a short last chunk included), against the JAX oracle and,
    where S divides into chunks, the JAX model's ``ssd_chunked`` (y at the
    JAX limit, the fp32 final state at the fp32 one)."""
    b, S, H, P, N, chunk, dtype = case
    jin, tin, raw, _ = _ssd_case(case, 1)
    y, state = _ssd_tensor_core_emulation(*tin, chunk)
    want = jax_ref.ssd_scan_ref(jin[0], jin[1], jnp.asarray(raw[2]), *jin[3:])
    assert max_ratio(y.float().numpy(), want) < ssd_limit(dtype)
    if S % chunk == 0:
        y_model, s_model = jax_mamba.ssd_chunked(
            *(jnp.asarray(t.float().numpy()) for t in tin), chunk=chunk)
        assert max_ratio(y.float().numpy(), y_model) < ssd_limit(dtype)
        assert max_ratio(state.numpy(), s_model) < ssd_limit("float32")


# K3's fp32 route (3xTF32 on mma.sync m16n8k8): every fp32 case, and the
# training shape (the train CLI's 8 x 256 tokens at mamba2-370m's widths,
# one chunk) at a reduced H.
# Which TF32 product counts keep the fp32 route within the fp32 limit on
# every case: three (worst max_ratio 3.8e-6 on the CPU); two (the second
# operand rounded to TF32 once) read 2.3e-4 to 5.3e-4 and one 3.2e-4 to
# 7.1e-4, against 1e-4.
TF32_TERMS_PASS = {3: True, 2: False, 1: False}
SSD_TF32_CASES = ([c for c in SSD_CASES + SSD_RAGGED_CASES + SSD_CORNER_CASES
                   if c[6] == "float32"]
                  + [SSD_BACKWARD_TRAIN_CASE[:2] + (2,)
                     + SSD_BACKWARD_TRAIN_CASE[3:]])


@functools.lru_cache(maxsize=None)
def _ssd_jax_refs(case) -> tuple:
    """The JAX oracle's y and, where S divides into chunks, the JAX model's
    ``ssd_chunked`` (y, final state) on ``_ssd_case(case, 1)``'s inputs."""
    b, S, H, P, N, chunk, dtype = case
    jin, tin, raw, _ = _ssd_case(case, 1)
    oracle = jax_ref.ssd_scan_ref(jin[0], jin[1], jnp.asarray(raw[2]),
                                  *jin[3:])
    model = (jax_mamba.ssd_chunked(*(jnp.asarray(t.float().numpy())
                                     for t in tin), chunk=chunk)
             if S % chunk == 0 else None)
    return oracle, model


@pytest.mark.parametrize("terms", [3, 2, 1],
                         ids=["3xtf32", "two_terms", "tf32"])
@pytest.mark.parametrize("case", SSD_TF32_CASES, ids=ssd_case_id)
def test_ssd_tf32_emulation_matches_jax(case, terms):
    """The fp32 route's order and rounding (every product over k-slices of
    8, each as lo.hi + hi.lo + hi.hi) against the JAX oracle and, where S
    divides into chunks, the JAX model's ``ssd_chunked`` (y and the final
    state) at the fp32 limit.  One TF32 product (hi.hi) and two (lo.hi +
    hi.hi) are read beside it: TF32_TERMS_PASS says which pass, and the
    test holds that.  ``pytest -s`` prints the readings."""
    chunk = case[5]
    _, tin, _, _ = _ssd_case(case, 1)
    oracle, model = _ssd_jax_refs(case)
    y, state = _ssd_tensor_core_emulation(*tin, chunk, terms, tf32=True)
    ratios = {"oracle y": max_ratio(y.numpy(), oracle)}
    if model is not None:
        ratios["ssd_chunked y"] = max_ratio(y.numpy(), model[0])
        ratios["ssd_chunked state"] = max_ratio(state.numpy(), model[1])
    limit = ssd_limit("float32")
    passes = max(ratios.values()) < limit
    print(f"K3 fp32 route, {terms} TF32 product(s), {ssd_case_id(case)}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in ratios.items())
          + f" (limit {limit}): {'passes' if passes else 'fails'}")
    assert passes == TF32_TERMS_PASS[terms], ratios


# The MoE and embedding-input families' shapes, as each model's attention
# and Mamba2 sublayers hand them to the kernels.
FAMILY_SHAPES = {
    "deepseek-moe-16b": (16, 16, 128, True, None),
    "hubert-xlarge": (16, 16, 80, False, None),
    "llava-next-34b": (56, 8, 128, True, None),
    "mixtral-8x22b": (48, 8, 128, True, 4096),
    "jamba-1.5-large-398b": (64, 8, 128, True, None),
    "qwen2-0.5b": (14, 2, 64, True, None),
}


@pytest.mark.parametrize("case", FAMILY_MAIN_CASES, ids=case_id)
def test_family_flash_cases_are_well_formed(case):
    """bf16 (the tensor-core route), a whole GQA group, a window below S,
    and the heads of one of the configs they stand for."""
    from repro_torch.configs import get_config
    B, Hq, Hkv, S, D, causal, window, dtype = case
    assert dtype == "bfloat16" and D % 8 == 0 and Hq % Hkv == 0
    assert window is None or 1 <= window < S
    assert any((Hq, Hkv, D, causal, window) == shape
               and (cfg := get_config(arch)).num_heads == Hq
               and cfg.num_kv_heads == Hkv and cfg.head_dim == D
               and cfg.causal == causal and cfg.sliding_window == window
               for arch, shape in FAMILY_SHAPES.items())


@pytest.mark.parametrize("case", DECODE_FAMILY_MAIN_CASES, ids=decode_case_id)
def test_family_decode_cases_are_well_formed(case):
    B, Hq, Hkv, S, D, index, window, dtype = case
    assert dtype == "bfloat16" and D % 8 == 0 and Hq % Hkv == 0
    assert 0 <= index < S
    assert window is None or 1 <= window <= index     # the window bites


@pytest.mark.parametrize("case", SSD_FAMILY_MAIN_CASES, ids=ssd_case_id)
def test_family_ssd_cases_are_well_formed(case):
    from repro_torch.configs import get_config, get_smoke_config
    b, S, H, P, N, chunk, dtype = case
    assert dtype == "bfloat16" and N % 16 == 0 and 1 <= chunk <= S
    widths = [(c.ssm.num_heads(c.d_model), c.ssm.head_dim, c.ssm.d_state,
               c.ssm.chunk_size)
              for c in (get_config("jamba-1.5-large-398b"),
                        get_smoke_config("jamba-1.5-large-398b"))]
    assert (H, P, N, chunk) in widths


# -- K1's backward: the plain version (the kernel runs only on the card) ---

# The JAX package's FLASH_CASES in fp32, and a ragged one with a window.
BWD_JAX_CASES = ([c for c in FLASH_CASES if c[7] == "float32"]
                 + [RAGGED_CASES[1]])
# Two fp32 materialisations of the same gradient, summed in different
# orders: an order below the kernel's BACKWARD_LIMIT.
BWD_REF_LIMIT = 1e-5


@pytest.mark.parametrize("case", BWD_JAX_CASES, ids=case_id)
def test_flash_attention_bwd_ref_matches_jax_grad(case):
    """flash_attention_bwd_ref against jax.grad of the JAX package's
    kernels/ref.py::flash_attention_ref, on the same inputs and dO."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(B, Hq, Hkv, S, D, dtype, seed=5)
    do = np.random.default_rng(6).standard_normal((B, Hq, S, D)).astype(
        np.float32)

    def objective(a, b, c):
        out = jax_ref.flash_attention_ref(a, b, c, causal=causal,
                                          window=window)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(objective, argnums=(0, 1, 2))(jq, jk, jv)
    got = flash_attention_bwd_ref(q, k, v, torch.from_numpy(do),
                                  causal=causal, window=window)
    for name, t, g, w in zip(("dq", "dk", "dv"), (q, k, v), got, want):
        assert g.shape == t.shape and g.dtype == t.dtype
        assert max_ratio(g.numpy(), np.asarray(w)) <= BWD_REF_LIMIT, name


def test_wrapper_gradient_on_cpu_is_the_plain_backward():
    """On the CPU the wrapper runs the differentiable plain version: its
    autograd gradient is flash_attention_bwd_ref's, and nothing launches."""
    B, Hq, Hkv, S, D = 1, 4, 2, 70, 64
    (_, _, _), (q, k, v) = _inputs(B, Hq, Hkv, S, D, "float32", seed=7)
    do = torch.randn((B, Hq, S, D), generator=torch.Generator().manual_seed(8))
    counts = (flash_attention.launches, flash_attention.lse_launches,
              flash_attention.backward_launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, window=20)
    assert out.grad_fn is not None
    out.backward(do)
    want = flash_attention_bwd_ref(q, k, v, do, causal=True, window=20)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    assert counts == (flash_attention.launches, flash_attention.lse_launches,
                      flash_attention.backward_launches)


@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_ops_flash_attention_is_differentiable_on_cpu(impl):
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 64, 56, "float32", seed=9)
    q.requires_grad_(True)
    out = ops.flash_attention(q, k, v, impl=impl)
    (g,) = torch.autograd.grad(out.square().sum(), q)
    assert g.shape == q.shape and bool(torch.isfinite(g).all())


@pytest.mark.parametrize("case", BACKWARD_CASES + BACKWARD_BF16_CASES,
                         ids=case_id)
def test_backward_cases_are_well_formed(case):
    """The kernels' shapes: fp32 with D % 4 == 0 (BACKWARD_CASES) or bf16
    with D % 8 == 0 (BACKWARD_BF16_CASES), D <= 128, GQA."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    multiple = 4 if case in BACKWARD_CASES else 8
    assert dtype == ("float32" if multiple == 4 else "bfloat16")
    assert D <= 128 and D % multiple == 0 and Hq % Hkv == 0
    assert window is None or 1 <= window


def test_backward_cases_cover_the_training_shape_and_its_corners():
    assert BACKWARD_TRAIN_CASE in BACKWARD_CASES
    assert any(not c[5] for c in BACKWARD_CASES)              # bidirectional
    assert any(c[6] is not None and c[6] < 32 for c in BACKWARD_CASES)
    assert any(c[3] % 32 for c in BACKWARD_CASES)              # ragged S
    assert BACKWARD_LIMIT == 1e-4
    assert BACKWARD_BF16_TRAIN_CASE in BACKWARD_BF16_CASES
    assert {c[:7] for c in BACKWARD_BF16_CASES} >= {
        c[:7] for c in FLASH_CASES + RAGGED_CASES + TENSOR_CORE_CASES
        if c[7] == "bfloat16"}
    assert {c[2] for c in BACKWARD_BF16_CASES} >= {1, 2, 8, 16}


# -- K1's fp32 route on the tensor cores: a model of its rounding ----------
#
# csrc/flash_attention.cu and csrc/flash_attention_bwd.cu run every product
# with TF32 operands (mma.sync m16n8k8), each fp32 operand split into
# hi = tf32(x) and lo = tf32(x - hi) and a product taken as lo.hi + hi.lo +
# hi.hi over k-slices of 8 ("3xTF32").  The model below rounds as they do;
# with one term (hi.hi, plain TF32) the forward misses the fp32 limit.

TF32_FORWARD_CASES = ([c for c in FLASH_CASES + RAGGED_CASES
                       if c[7] == "float32"] + [BACKWARD_TRAIN_CASE])
# The training shape, and a ragged GQA case with a window (group 4).
TF32_BACKWARD_CASES = [BACKWARD_TRAIN_CASE, RAGGED_CASES[1]]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero (cvt.rna.tf32.f32), through an int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 with ties to even (cvt.rn.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000).view(torch.float32)


def _split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int,
                  acc=None, rnd=_tf32) -> torch.Tensor:
    """``acc + a @ b`` as the kernels take it: k-slices of 8 in order, each
    the sum of lo.hi, hi.lo and hi.hi (``terms`` 3), of lo.hi and hi.hi
    (``terms`` 2: b rounded to TF32 once) or of hi.hi alone (``terms`` 1),
    added into an fp32 accumulator; ``rnd`` rounds to TF32 (ties away from
    zero, or ``_tf32_rn``'s to even)."""
    out = torch.zeros(()) if acc is None else acc
    for k0 in range(0, a.shape[-1], 8):
        x, y = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        xh, yh = rnd(x), rnd(y)
        if terms >= 2:
            out = out + rnd(x - xh) @ yh
        if terms == 3:
            out = out + xh @ rnd(y - yh)
        out = out + xh @ yh
    return out


def _mask(S: int, causal: bool, window) -> torch.Tensor:
    qp, kp = torch.arange(S)[:, None], torch.arange(S)[None, :]
    keep = torch.ones((S, S), dtype=torch.bool)
    if causal:
        keep &= qp >= kp
    if window is not None:
        keep &= qp - kp < window
    return keep


def _fp32_route_forward(q, k, v, causal, window, terms: int,
                        block_k: int = 64) -> tuple:
    """The fp32 forward kernel's order and rounding on the CPU: 64-key
    tiles, online softmax in fp32 (masked scores -1e30, alpha rescales),
    S = Q K^T and P V split as the kernel splits them.  Returns (o, lse)."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    keep = _mask(S, causal, window)
    m = torch.full((B, Hq, S, 1), -1e30)
    l = torch.zeros((B, Hq, S, 1))
    acc = torch.zeros((B, Hq, S, D))
    for k0 in range(0, S, block_k):
        sl = slice(k0, k0 + block_k)
        s = _split_matmul(q.float(), kf[:, :, sl].transpose(-1, -2),
                          terms) * D ** -0.5
        s = torch.where(keep[:, sl], s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = _split_matmul(p, vf[:, :, sl], terms, acc * alpha)
        m = m_new
    l = l.clamp_min(1e-30)
    return acc / l, (m + torch.log(l))[..., 0]


def _fp32_route_backward(q, k, v, do, causal, window, terms: int) -> tuple:
    """The backward kernel's arithmetic on the CPU: P rebuilt from the
    modelled forward's lse, every one of the five products split, dK and dV
    summed over a GQA group in head order.  Returns (dq, dk, dv)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    scale = D ** -0.5
    o, lse = _fp32_route_forward(q, k, v, causal, window, terms)
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    delta = (do * o).sum(-1, keepdim=True)
    s = _split_matmul(q, kf.transpose(-1, -2), terms)
    p = torch.where(_mask(S, causal, window),
                    torch.exp(s * scale - lse[..., None]), torch.zeros(()))
    ds = p * (_split_matmul(do, vf.transpose(-1, -2), terms) - delta)
    dq = _split_matmul(ds, kf, terms) * scale
    dk = _split_matmul(ds.transpose(-1, -2), q, terms) * scale
    dv = _split_matmul(p.transpose(-1, -2), do, terms)
    dk = dk.reshape(B, Hkv, group, S, D)
    dv = dv.reshape(B, Hkv, group, S, D)
    dk_sum, dv_sum = dk[:, :, 0], dv[:, :, 0]
    for g in range(1, group):
        dk_sum, dv_sum = dk_sum + dk[:, :, g], dv_sum + dv[:, :, g]
    return dq, dk_sum, dv_sum


def test_tf32_rounding_model():
    """_tf32 keeps 10 explicit mantissa bits, rounds half away from zero,
    and hi + lo of the split carries x to about 22 bits."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11), 3.0e-3])
    got = _tf32(x)
    assert got[:4].tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0]
    assert float(got[4]) == -(1.0 + 2.0 ** -10)
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    r = torch.from_numpy(np.random.default_rng(20).standard_normal(
        4096).astype(np.float32))
    hi = _tf32(r)
    lo = _tf32(r - hi)
    assert float(((hi - r).abs() / r.abs()).max()) <= 2.0 ** -11
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -21


def test_tf32_rn_rounding_model():
    """_tf32_rn keeps 10 explicit mantissa bits and rounds ties to even,
    where _tf32 rounds them away from zero; elsewhere the two agree."""
    tie = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                        -(1.0 + 2.0 ** -11)])
    assert _tf32_rn(tie).tolist() == [1.0, 1.0 + 2 * 2.0 ** -10, -1.0]
    assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10,
                                   -(1.0 + 2.0 ** -10)]
    r = torch.from_numpy(np.random.default_rng(21).standard_normal(
        4096).astype(np.float32))
    off_tie = (r.view(torch.int32) & 0x1FFF) != 0x1000
    assert torch.equal(_tf32_rn(r)[off_tie], _tf32(r)[off_tie])
    hi = _tf32_rn(r)
    assert float(((hi + _tf32_rn(r - hi) - r).abs() / r.abs()).max()) <= (
        2.0 ** -21)


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "tf32"])
@pytest.mark.parametrize("case", TF32_FORWARD_CASES, ids=case_id)
def test_fp32_route_rounding_meets_fp32_limit_only_with_split(case, terms):
    """The fp32 route's rounding against the JAX oracle: with the split
    (three products) within tolerance("float32") on every fp32 case; with
    one TF32 product (hi.hi) outside it."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(B, Hq, Hkv, S, D, dtype, seed=20)
    got, _ = _fp32_route_forward(q, k, v, causal, window, terms)
    want = np.asarray(jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                  window=window), np.float32)
    tol = tolerance(dtype)
    inside = np.abs(got.numpy() - want) <= tol["atol"] + tol["rtol"] * np.abs(
        want)
    assert bool(inside.all()) == (terms == 3)


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "tf32"])
@pytest.mark.parametrize("case", TF32_BACKWARD_CASES, ids=case_id)
def test_fp32_backward_rounding_meets_backward_limit_only_with_split(case,
                                                                     terms):
    """dq, dk, dv with every product of the backward (and of the forward
    that saves lse) split as the kernels split them, against jax.grad of
    the JAX oracle: within BACKWARD_LIMIT with three products, outside it
    with one."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(B, Hq, Hkv, S, D, dtype, seed=21)
    do = np.random.default_rng(22).standard_normal((B, Hq, S, D)).astype(
        np.float32)

    def objective(a, b, c):
        out = jax_ref.flash_attention_ref(a, b, c, causal=causal,
                                          window=window)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(objective, argnums=(0, 1, 2))(jq, jk, jv)
    got = _fp32_route_backward(q, k, v, torch.from_numpy(do), causal, window,
                               terms)
    ratios = [max_ratio(g.numpy(), np.asarray(w)) for g, w in zip(got, want)]
    assert (max(ratios) <= BACKWARD_LIMIT) == (terms == 3), ratios


# -- K1's bf16 backward: the plain version and a model of its rounding ----
#
# The JAX package differentiates its jnp flash_attention_jnp, which casts
# q, k and v to fp32 and the output back: for bf16 inputs its gradient is
# the fp32 gradient rounded to bf16 once.  (Its kernels/ref.py repeats k and
# v over the group in bf16, so its dK and dV round each head's share before
# the sum: 2.6e-3 of their rms at group 7.)

# The JAX test's bf16 shape, a window below one tile at D 128, and a
# bidirectional ragged S.
BWD_BF16_JAX_CASES = [FLASH_CASES[6], TENSOR_CORE_CASES[5],
                      TENSOR_CORE_CASES[6]]


def _bf16_inputs(case, seed: int) -> tuple:
    """(JAX bf16 q, k, v, dO; the same as torch bf16 tensors)."""
    B, Hq, Hkv, S, D = case[:5]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D))]
    return ([jnp.asarray(a).astype(jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


def _jnp_grad(jq, jk, jv, jdo, causal, window) -> tuple:
    """jax.grad of sum(flash_attention_jnp(q, k, v) * dO), in its
    [B, S, H, D] layout, one chunk of S rows."""
    S = jq.shape[2]
    tr = functools.partial(jnp.swapaxes, axis1=1, axis2=2)

    def objective(a, b, c):
        out = flash_attention_jnp(tr(a), tr(b), tr(c), causal=causal,
                                  window=window, chunk_q=S, chunk_k=S)
        return jnp.sum((tr(out) * jdo).astype(jnp.float32))

    return jax.grad(objective, argnums=(0, 1, 2))(jq, jk, jv)


def _torch32(a) -> torch.Tensor:
    """A JAX array as an fp32 torch tensor."""
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("case", BWD_BF16_JAX_CASES, ids=case_id)
def test_flash_attention_bwd_ref_matches_jax_grad_bf16(case):
    """flash_attention_bwd_ref on bf16 inputs against jax.grad of the JAX
    model's attention on the same inputs: each gradient bf16, within about
    one bf16 ulp of max |want| and 1e-4 of its rms (readings: 4.8e-5 rms,
    1.2e-3 max; two fp32 sums in different orders, rounded once)."""
    B, Hq, Hkv, S, D, causal, window, dtype = case
    (jq, jk, jv, jdo), (q, k, v, do) = _bf16_inputs(case, seed=23)
    want = _jnp_grad(jq, jk, jv, jdo, causal, window)
    got = flash_attention_bwd_ref(q, k, v, do, causal=causal, window=window)
    for name, t, g, w in zip(("dq", "dk", "dv"), (q, k, v), got, want):
        assert g.shape == t.shape and g.dtype == torch.bfloat16, name
        assert max_ratio(g.float().numpy(), np.asarray(w, np.float32)) \
            <= 2.0 ** -8, name
        assert _rms_ratio(g, _torch32(w)) <= 1e-4, name


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _fp16(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to fp16 after a power-of-two scale per row that puts the
    row's largest |value| in [2^14, 2^15), and scaled back (exactly)."""
    top = a.abs().amax(-1, keepdim=True)
    scale = torch.exp2(14 - torch.where(top > 0, torch.floor(torch.log2(top)),
                                        torch.zeros_like(top)))
    return (a * scale).to(torch.float16).float() / scale


def _bf16_product(a: torch.Tensor, b: torch.Tensor, rounding: str,
                  acc=None) -> torch.Tensor:
    """``acc + a @ b`` as the bf16 kernel takes it: bf16 operands (b is
    exact in bf16), k-slices of 16 in order, each added into an fp32
    accumulator.  The fp32 ``a`` runs as bf16 hi and lo, lo first
    (``rounding`` "split"), as bf16 alone ("bf16"), or as one fp16 product
    with a power-of-two scale per row ("fp16"; b's bf16 values convert to
    fp16 exactly under such scales, so b stays as it is)."""
    hi = _bf16(a)
    terms = {"split": lambda: [_bf16(a - hi), hi], "bf16": lambda: [hi],
             "fp16": lambda: [_fp16(a)]}[rounding]()
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 16):
        for t in terms:
            out = out + t[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return out


def _bf16_route_backward(q, k, v, do, causal, window, p_rounding: str,
                         ds_rounding: str, fp32_o: bool) -> tuple:
    """The bf16 backward kernel's arithmetic on the CPU: S and dP from the
    bf16 operands in fp32, P rebuilt from the forward's row log-sum-exp,
    delta = rowsum(dO o O) from the fp32 O (``fp32_o``) or the bf16 one, P
    (in dV) and dS (in dK and dQ) as the products of ``_bf16_product``'s
    ``rounding``, each 16-row k slice of a 64-row tile in order, dK and dV
    summed over a GQA group in head order in fp32 (each query head's share
    rounded to fp32, then added).  Returns bf16 (dq, dk, dv)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    scale = D ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    keep = _mask(S, causal, window)
    s = _bf16_product(qf, kf.transpose(-1, -2), "bf16") * scale
    s = torch.where(keep, s, torch.tensor(-1e30))
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.where(keep, torch.exp(s - lse), torch.zeros(()))
    o = p @ vf
    delta = (dof * (o if fp32_o else _bf16(o))).sum(-1, keepdim=True)
    ds = p * (_bf16_product(dof, vf.transpose(-1, -2), "bf16") - delta)
    dq = _bf16_product(ds, kf, ds_rounding) * scale
    dk = _bf16_product(ds.transpose(-1, -2), qf, ds_rounding) * scale
    dv = _bf16_product(p.transpose(-1, -2), dof, p_rounding)
    dk = dk.reshape(B, Hkv, group, S, D)
    dv = dv.reshape(B, Hkv, group, S, D)
    dk_sum, dv_sum = dk[:, :, 0], dv[:, :, 0]
    for g in range(1, group):
        dk_sum, dv_sum = dk_sum + dk[:, :, g], dv_sum + dv[:, :, g]
    return tuple(t.to(torch.bfloat16) for t in (dq, dk_sum, dv_sum))


@functools.lru_cache(maxsize=None)
def _bf16_design_case(case) -> tuple:
    """(torch bf16 q, k, v, dO; jax.grad of the JAX model's attention)."""
    (jq, jk, jv, jdo), inputs = _bf16_inputs(case, seed=21)
    return inputs, _jnp_grad(jq, jk, jv, jdo, *case[5:7])


# (P's rounding in dV, dS's in dK and dQ, delta from the fp32 O): the
# kernel's design first, then each of the roundings it rejects: delta from
# the bf16 O, P or dS in bf16 alone, or P or dS as one fp16 product (with a
# power-of-two scale per row) in place of the hi/lo pair.
BF16_BWD_DESIGNS = {"split_fp32_o": ("split", "split", True),
                    "bf16_o": ("split", "split", False),
                    "bf16_p": ("bf16", "split", True),
                    "bf16_ds": ("split", "bf16", True),
                    "fp16_p": ("fp16", "split", True),
                    "fp16_ds": ("split", "fp16", True)}


@pytest.mark.parametrize("design", sorted(BF16_BWD_DESIGNS))
@pytest.mark.parametrize("case", [BACKWARD_BF16_TRAIN_CASE, RAGGED_CASES[2]],
                         ids=case_id)
def test_bf16_backward_rounding_meets_limits_only_as_designed(case, design):
    """dq, dk and dv with the bf16 backward's rounding against jax.grad of
    the JAX model's attention: with P and dS split and delta from the fp32
    O, each within BACKWARD_BF16_LIMIT and BACKWARD_BF16_RMS_LIMIT (and
    MAIN_RMS_LIMIT); with any one of them rounded as the bf16 forward's
    output is, or P or dS taken as one fp16 product, some gradient outside
    the rms limit."""
    (q, k, v, do), want = _bf16_design_case(case)
    got = _bf16_route_backward(q, k, v, do, *case[5:7],
                               *BF16_BWD_DESIGNS[design])
    rms = [_rms_ratio(g, _torch32(w)) for g, w in zip(got, want)]
    ratios = [max_ratio(g.float().numpy(), np.asarray(w, np.float32))
              for g, w in zip(got, want)]
    if design == "split_fp32_o":
        assert max(ratios) <= BACKWARD_BF16_LIMIT, ratios
        assert max(rms) <= min(BACKWARD_BF16_RMS_LIMIT, MAIN_RMS_LIMIT), rms
    else:
        assert max(rms) > BACKWARD_BF16_RMS_LIMIT, rms


@pytest.mark.parametrize("seed", range(5))
def test_bf16_backward_rounding_at_one_key(seed):
    """At S 1 the one key takes all the weight: the plain dq and dk are
    exactly 0 and dv is dO; the model of the kernel's rounding leaves dq
    and dk within BACKWARD_BF16_ZERO_ATOL (fp32 rounding of dP - delta) and
    dv within the limits."""
    case = TENSOR_CORE_CASES[2]
    assert case[3] == 1 and case in BACKWARD_BF16_CASES
    _, (q, k, v, do) = _bf16_inputs(case, seed)
    got = _bf16_route_backward(q, k, v, do, *case[5:7],
                               *BF16_BWD_DESIGNS["split_fp32_o"])
    want = flash_attention_bwd_ref(q, k, v, do, causal=case[5],
                                   window=case[6])
    assert [float(w.float().abs().max()) == 0.0 for w in want] == [
        True, True, False]
    for g, w in zip(got, want):
        assert bf16_backward_check(g, w)[2]


# -- K3's backward: its formulas and the plain version (the kernel runs only
# on the card) ----------------------------------------------------------------

# The JAX package's SSD_CASES in fp32, each with the JAX test's dt and
# with a slowly decaying dt (log-uniform in [1e-3, 1e-1], Mamba2's init
# range): with the JAX test's dt the state barely carries across a chunk,
# so only the slow draw reaches the terms of the state entering and
# leaving it.
SSD_BWD_JAX_CASES = [c for c in SSD_CASES if c[6] == "float32"]
SSD_DRAWS = ("jax_dt", "slow_decay")


def _ssd_bwd_inputs(b, S, H, P, N, draw: str, seed: int = 11) -> tuple:
    """x, dt, A, B, C, dy and dstate as numpy fp32."""
    x, dt, A, B, C = _ssd_inputs(b, S, H, P, N, "float32", seed)[2]
    rng = np.random.default_rng(seed + 1)
    if draw == "slow_decay":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                                (b, S, H))).astype(np.float32)
    dy = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dstate = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return x, dt, A, B, C, dy, dstate


@functools.lru_cache(maxsize=None)
def _jax_ssd_vjp(case: tuple, draw: str) -> tuple:
    """jax.vjp of the JAX model's ssd_chunked at one case's inputs, with
    cotangents dy and dstate: (dx, ddt, dA, dB, dC) as numpy."""
    b, S, H, P, N, chunk, _ = case
    arrs = [jnp.asarray(a) for a in _ssd_bwd_inputs(b, S, H, P, N, draw)]

    @jax.jit
    def grads(x, dt, A, B, C, dy, dstate):
        _, vjp = jax.vjp(functools.partial(jax_mamba.ssd_chunked,
                                           chunk=chunk), x, dt, A, B, C)
        return vjp((dy, dstate))

    return tuple(np.asarray(g) for g in grads(*arrs))


def _ssd_bwd_launch_model(x, dt, A, B, C, dy, dstate, chunk: int,
                          drop: str = None, terms: int = 3) -> tuple:
    """The formulas of csrc/ssd_scan_bwd.cu's five launches, per chunk and
    vectorised over batch and heads, in the kernel's precisions and order:
    inputs widened to fp32; every product over k-slices of 8 in
    ``terms`` TF32 products each (``_split_matmul`` with ties rounded to
    even; the kernel's 3, where a bf16 input has no lo term), with the
    operands in the kernel's roles
    (the du and dB blocks' S^T = B_j C_i^T and (dy . x)^T = x_j dy_i^T, the
    row blocks' dy_i x_j^T, dt_j applied to each score after its product);
    cs summed in fp64 and kept as fp32 (hi, lo) pairs; s = W (dy . u) in
    fp32, its column sums and each row's partial sums over the 64-key tiles
    in fp64, the partials added in tile order; dcs, its reverse cumulative
    sum and the dA partials in fp64; each gradient rounded to its input's
    dtype at the end.  ``drop`` leaves out one term ("carry":
    exp(cs_last) <h-, G> in dcs_last; "state_du": G B_j in du_j), for the
    check that the limits and the draws see it."""
    b, S, H, P = x.shape
    xf, dtf, Bf, Cf, dyf = (t.float() for t in (x, dt, B, C, dy))
    a = dtf * A.float()
    chunk = min(chunk, S)
    spans = [(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
    hi, lo = torch.empty_like(a), torch.empty_like(a)
    for c0, c1 in spans:                     # the forward's cs pairs
        cs = torch.cumsum(a[:, c0:c1].double(), 1)
        hi[:, c0:c1] = cs.float()
        lo[:, c0:c1] = (cs - cs.float().double()).float()
    pair = hi + lo                           # exp(cs_i) takes hi + lo

    def mm(u, v):
        return _split_matmul(u, v, terms, rnd=_tf32_rn)

    def decay(i, j):                         # exp(cs_i - cs_j), [b, i, j, H]
        return torch.exp((hi[:, i, None] - hi[:, None, j])
                         + (lo[:, i, None] - lo[:, None, j]))

    def heads(t):                            # [b, l, H, P] -> [b, H, l, P]
        return t.permute(0, 2, 1, 3)

    u = xf * dtf[..., None]
    entering, h = [], torch.zeros((b, H, P, B.shape[-1]))
    for c0, c1 in spans:                     # the forward's states
        entering.append(h)
        t = torch.arange(c0, c1)
        w = decay(torch.tensor([c1 - 1]), t)[:, 0]
        own = torch.einsum("blh,blhp,bln->bhpn", w, u[:, c0:c1],
                           Bf[:, c0:c1])
        h = h * torch.exp(pair[:, c1 - 1])[..., None, None] + own
    # Launches 1 and 2: G_c, the gradient of the state leaving chunk c.
    leaving = [None] * len(spans)
    g = torch.zeros_like(h) if dstate is None else dstate.float()
    for c in reversed(range(len(spans))):
        c0, c1 = spans[c]
        leaving[c] = g
        ey = heads(dyf[:, c0:c1]) * torch.exp(pair[:, c0:c1]).transpose(
            1, 2)[..., None]                                 # [b, H, l, P]
        own = mm(ey.transpose(-1, -2), Cf[:, None, c0:c1])   # [b, H, P, N]
        g = torch.exp(pair[:, c1 - 1])[..., None, None] * g + own
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    dBh = torch.empty((b, H, S, B.shape[-1]))
    dCh = torch.empty_like(dBh)
    dA = torch.zeros(H, dtype=torch.float64)
    for c, (c0, c1) in enumerate(spans):
        t = torch.arange(c0, c1)
        n = c1 - c0
        Cc, Bc = Cf[:, None, c0:c1], Bf[:, None, c0:c1]      # [b, 1, l, N]
        dyc, xc = heads(dyf[:, c0:c1]), heads(xf[:, c0:c1])  # [b, H, l, P]
        dtc = dtf[:, c0:c1].transpose(1, 2)                  # [b, H, l]
        G, Hm = leaving[c], entering[c]
        # Launch 3.  L[i, j] an exact 0 where j > i.
        keep = torch.tril(torch.ones(n, n, dtype=torch.bool))
        L = torch.where(keep[None, :, :, None], decay(t, t), 0.0)
        L = L.permute(0, 3, 1, 2)                            # [b, H, i, j]
        LT = L.transpose(-1, -2)                             # [b, H, j, i]
        # du blocks: W^T = (B_j C_i^T) L^T, (dy . u)^T = dt_j (x_j dy_i^T),
        # s^T = W^T (dy . u)^T; du_j = W^T dy_i.
        WT = mm(Bc, Cc.transpose(-1, -2)) * LT
        DUT = mm(xc, dyc.transpose(-1, -2)) * dtc[..., None]
        sT = (WT * DUT).double()                             # [b, H, j, i]
        du = mm(WT, dyc)
        # dB blocks: M^T = (dy . u)^T L^T; dB_j = M^T C_i.
        dBc = mm(DUT * LT, Cc)
        # Row blocks: M = dt_j (dy_i x_j^T) L; dC_i = M B_j.
        dCc = mm(mm(dyc, xc.transpose(-1, -2)) * dtc[..., None, :] * L, Bc)
        # The state's terms.
        e_last = decay(torch.tensor([c1 - 1]), t)[:, 0].transpose(1, 2)
        e_in = torch.exp(pair[:, c0:c1]).transpose(1, 2)     # [b, H, l]
        GB = mm(Bc, G.transpose(-1, -2))                     # [b, H, l, P]
        if drop != "state_du":
            du = du + e_last[..., None] * GB
        w = (e_last * dtc * (xc * GB).sum(-1)).double()
        dBh[:, :, c0:c1] = dBc + (e_last * dtc)[..., None] * mm(xc, G)
        HD = mm(dyc, Hm)                                     # [b, H, l, N]
        dCh[:, :, c0:c1] = dCc + e_in[..., None] * HD
        r = (e_in * (Cc * HD).sum(-1)).double()
        dx[:, c0:c1] = (dtc[..., None] * du).transpose(1, 2)
        # Launch 4: each row's partials of s over the key tiles, in order;
        # dcs, its reverse cumulative sum da, ddt, dA's share.
        rows = torch.zeros_like(r)
        for k0 in range(0, n, 64):
            rows = rows + sT[:, :, k0:k0 + 64].sum(-2)
        dcs = rows + r - (sT.sum(-1) + w)                    # [b, H, l]
        if drop != "carry":
            dcs[..., -1] += (torch.exp(pair[:, c1 - 1]).double()
                             * (Hm.double() * G.double()).sum((-1, -2)))
        dcs[..., -1] += w.sum(-1)
        da = dcs.flip(-1).cumsum(-1).flip(-1).transpose(1, 2)  # [b, l, H]
        ddt[:, c0:c1] = ((xc * du).sum(-1).transpose(1, 2).double()
                         + A.float().double() * da).float()
        dA += (dtf[:, c0:c1].double() * da).sum((0, 1))
    # Launch 5: the head sums of dB and dC, dA's sum.
    out = (dx, ddt, dA.float(), dBh.sum(1), dCh.sum(1))
    return tuple(g.to(t.dtype) for g, t in zip(out, (x, dt, A, B, C)))


# Which TF32 product counts keep the backward's route within the fp32 limit
# against jax.vjp of ssd_chunked on SSD_BWD_JAX_CASES, both draws: three
# (the kernel's); one (hi.hi, every fp32 operand rounded to TF32) is read
# beside it.
SSD_BWD_TF32_TERMS_PASS = {3: True, 1: False}


@pytest.mark.parametrize("draw", SSD_DRAWS)
@pytest.mark.parametrize("case", SSD_BWD_JAX_CASES, ids=ssd_case_id)
def test_ssd_scan_bwd_ref_matches_jax_vjp(case, draw):
    """The plain backward (autograd through the token recurrence) against
    jax.vjp of the JAX model's ssd_chunked, with random cotangents on y
    and on the final state: each gradient within the JAX SSD test's fp32
    limit of max |ref|."""
    b, S, H, P, N, chunk, dtype = case
    arrs = [torch.from_numpy(a) for a in _ssd_bwd_inputs(b, S, H, P, N, draw)]
    got = ssd_scan_bwd_ref(*arrs)
    for name, t, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), arrs, got,
                             _jax_ssd_vjp(case, draw)):
        assert g.shape == t.shape and g.dtype == t.dtype, name
        assert max_ratio(g.numpy(), w) < ssd_limit(dtype), name


@pytest.mark.parametrize("draw", SSD_DRAWS)
@pytest.mark.parametrize("case", SSD_BWD_JAX_CASES, ids=ssd_case_id)
def test_ssd_bwd_launch_model_matches_jax_vjp(case, draw):
    """The backward kernel's formulas, in its precisions, against jax.vjp
    of ssd_chunked: each gradient within the fp32 limit."""
    b, S, H, P, N, chunk, dtype = case
    arrs = [torch.from_numpy(a) for a in _ssd_bwd_inputs(b, S, H, P, N, draw)]
    got = _ssd_bwd_launch_model(*arrs, chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                          _jax_ssd_vjp(case, draw)):
        assert max_ratio(g.numpy(), w) < ssd_limit(dtype), name


@pytest.mark.parametrize("draw", SSD_DRAWS)
@pytest.mark.parametrize("case", SSD_RAGGED_CASES, ids=ssd_case_id)
def test_ssd_bwd_launch_model_matches_plain_backward(case, draw):
    """Where JAX's ssd_chunked refuses the shape (S not a multiple of the
    chunk: a short last chunk), the formulas against the plain backward,
    in the case's dtype, at the card's limits (cases.py)."""
    b, S, H, P, N, chunk, dtype = case
    tdt = DTYPES[dtype][1]
    arrs = [torch.from_numpy(a).to(tdt)
            for a in _ssd_bwd_inputs(b, S, H, P, N, draw)]
    arrs[-1] = arrs[-1].float()                  # the state is fp32
    got = _ssd_bwd_launch_model(*arrs, chunk)
    want = ssd_scan_bwd_ref(*arrs)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype == tdt, name
        assert ssd_backward_check(g, w, dtype)[2], (name, ssd_backward_check(
            g, w, dtype))


@pytest.mark.parametrize("terms", [3, 1], ids=["3xtf32", "tf32"])
def test_ssd_bwd_tf32_terms_meet_fp32_limit_only_with_split(terms):
    """The backward's route with ``terms`` TF32 products per k-slice
    against jax.vjp of ssd_chunked on every SSD_BWD_JAX_CASES case, both
    draws: the worst max_ratio over the five gradients at the fp32 limit.
    SSD_BWD_TF32_TERMS_PASS says which counts pass, and the test holds
    that.  ``pytest -s`` prints the readings."""
    readings = {}
    for case in SSD_BWD_JAX_CASES:
        b, S, H, P, N, chunk, _ = case
        for draw in SSD_DRAWS:
            arrs = [torch.from_numpy(a)
                    for a in _ssd_bwd_inputs(b, S, H, P, N, draw)]
            got = _ssd_bwd_launch_model(*arrs, chunk, terms=terms)
            readings[(ssd_case_id(case), draw)] = max(
                max_ratio(g.numpy(), w)
                for g, w in zip(got, _jax_ssd_vjp(case, draw)))
    worst = max(readings.values())
    passes = worst < SSD_BACKWARD_LIMIT
    print(f"K3 backward route, {terms} TF32 product(s): "
          + ", ".join(f"{c} {d} {v:.3e}" for (c, d), v in readings.items())
          + f" (limit {SSD_BACKWARD_LIMIT}): "
          + ("passes" if passes else "fails"))
    assert passes == SSD_BWD_TF32_TERMS_PASS[terms], readings


@pytest.mark.parametrize("drop", ["carry", "state_du"])
def test_ssd_bwd_limits_see_the_state_terms_only_with_slow_decay(drop):
    """Leaving out a term of the state (the carry's decay in dcs_last, or
    G B_j in du_j) breaks the fp32 limit on the slow draw.  With the JAX
    test's dt the state decays within a chunk (exp(cs_last) about 1e-11 at
    chunk 32), so the carry's term passes there unseen: the reason both
    draws are checked."""
    case = SSD_BWD_JAX_CASES[1]
    b, S, H, P, N, chunk, _ = case
    seen = {}
    for draw in SSD_DRAWS:
        arrs = [torch.from_numpy(a)
                for a in _ssd_bwd_inputs(b, S, H, P, N, draw)]
        got = _ssd_bwd_launch_model(*arrs, chunk, drop=drop)
        seen[draw] = max(max_ratio(g.numpy(), w) for g, w in
                         zip(got, _jax_ssd_vjp(case, draw)))
    assert seen["slow_decay"] > 10 * SSD_BACKWARD_LIMIT, seen
    if drop == "carry":
        assert seen["jax_dt"] < SSD_BACKWARD_LIMIT, seen


def test_ssd_wrapper_gradient_on_cpu_is_the_plain_backward():
    """On the CPU the wrapper runs the differentiable plain version: its
    autograd gradient, through y and the final state, is ssd_scan_bwd_ref's
    bit for bit, and nothing launches."""
    b, S, H, P, N = 1, 40, 2, 8, 8
    arrs = [torch.from_numpy(a)
            for a in _ssd_bwd_inputs(b, S, H, P, N, "slow_decay")]
    counts = (ssd_scan.launches, ssd_scan.backward_launches)
    leaves = [t.clone().requires_grad_(True) for t in arrs[:5]]
    y, state = ssd_scan(*leaves, chunk=16)
    assert y.grad_fn is not None and state.grad_fn is not None
    torch.autograd.backward((y, state), (arrs[5], arrs[6]))
    want = ssd_scan_bwd_ref(*arrs)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    assert counts == (ssd_scan.launches, ssd_scan.backward_launches)


def test_copy_aligned_reads_base_and_strides():
    """The condition under which the kernels copy 16-byte pieces of rows
    (and the backward copies dy first where it fails): a 16-byte aligned
    base and outer strides that are multiples of 16 bytes, a dimension of
    one element aside."""
    from repro_torch.kernels import build
    x = torch.zeros((4, 8))
    assert build.copy_aligned(x) and build.copy_aligned(x[:, :4])
    assert not build.copy_aligned(x[:, 1:])          # base 4 bytes in
    assert not build.copy_aligned(torch.zeros((4, 6)))   # rows of 24 bytes
    assert build.copy_aligned(torch.zeros((4, 8), dtype=torch.bfloat16))
    assert build.copy_aligned(torch.zeros((1, 6)))   # one row


def test_ssd_backward_entry_refuses_cpu_tensors():
    arrs = [torch.from_numpy(a)
            for a in _ssd_bwd_inputs(1, 32, 2, 8, 8, "jax_dt")]
    x, dt, A, B, C, dy, _ = arrs
    cs = torch.zeros((1, 2, 32, 2))
    states = torch.zeros((1, 1, 2, 8, 8))
    n = ssd_scan.backward_launches
    with pytest.raises(ValueError, match="CUDA"):
        k3_lib.backward(x, dt, A, B, C, cs, states, dy, None, chunk=32)
    with pytest.raises(ValueError, match="CUDA"):
        k3_lib.forward_for_backward(x, dt, A, B, C, chunk=32)
    assert ssd_scan.backward_launches == n


def test_ssd_backward_cases_cover_the_paths():
    """Both dtypes of every forward case and of the main shape, the
    training shape at mamba2-370m's widths and the smoke width of both
    Mamba2 families; the timed shapes are the training shape, mamba2-370m's
    heads over 1024 tokens and jamba-1.5-large's."""
    from repro_torch.configs import get_config, get_smoke_config
    shapes = {c[:6] for c in SSD_BACKWARD_CASES}
    for c in SSD_CASES + SSD_RAGGED_CASES + SSD_CORNER_CASES + [SSD_MAIN_CASE]:
        assert {c[:6] + (d,) for d in ("float32", "bfloat16")} <= set(
            SSD_BACKWARD_CASES)
    assert len(set(SSD_BACKWARD_CASES)) == len(SSD_BACKWARD_CASES)

    def widths(cfg):
        s = cfg.ssm
        return (s.num_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk_size)

    full, smoke = get_config("mamba2-370m"), get_smoke_config("mamba2-370m")
    assert SSD_BACKWARD_TRAIN_CASE[:6] == (8, 256) + widths(full)
    assert SSD_BACKWARD_SMOKE_CASE[2:6] == widths(smoke) == widths(
        get_smoke_config("jamba-1.5-large-398b"))
    assert {SSD_BACKWARD_TRAIN_CASE[:6], SSD_BACKWARD_SMOKE_CASE[:6]} <= shapes
    jamba = get_config("jamba-1.5-large-398b")
    assert [t[2:] for t in SSD_BACKWARD_TIMED] == [widths(full)] * 2 + [
        widths(jamba)]
    for b, S, H, P, N, chunk, dtype in SSD_BACKWARD_CASES:
        assert P <= k3_lib.MAX_HEAD_DIM and N <= k3_lib.MAX_STATE
        assert P % 8 == 0 and N % 8 == 0 and chunk >= 1
