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
    ssd_scan_ref,
)
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


def _ssd_tensor_core_emulation(x, dt, A, B, C, chunk: int, terms: int = 3):
    """The chunk-parallel kernel's order and rounding on the CPU: per chunk
    the cumulative dA (summed in fp64, kept as an fp32 hi + lo pair), the
    chunk's own state, the recurrence over chunks in fp32, and the outputs
    (C . B^T exact in fp32; the decay-weighted scores, exp(cs_last - cs_j)
    dt_j x_j and the entering state h, the fp32 operands of the
    tensor-core products, as ``terms`` bf16 terms; the kernel uses 3).
    Returns (y in x's dtype, the fp32 final state)."""
    b, S, H, P = x.shape
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))
    h = torch.zeros((b, H, P, B.shape[-1]))
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        cl = sl.stop - c0
        d = dtf[:, sl]                                       # [b, cl, H]
        cs = torch.cumsum((d * Af).double(), dim=1)          # in fp64,
        hi = cs.float()                                      # kept as
        lo = (cs - hi.double()).float()                      # hi + lo
        w = torch.exp((hi[:, -1:] - hi) + (lo[:, -1:] - lo)) * d
        own = torch.einsum("bjhp,bjn->bhpn",
                           _bf16_terms(xf[:, sl] * w[..., None], terms),
                           Bf[:, sl])
        scores = torch.einsum("bin,bjn->bij", Cf[:, sl], Bf[:, sl])
        live = torch.tril(torch.ones((cl, cl), dtype=torch.bool))
        weighted = torch.where(
            live[None, :, :, None],
            scores[..., None] * (torch.exp((hi[:, :, None] - hi[:, None])
                                           + (lo[:, :, None] - lo[:, None]))
                                 * d[:, None]), torch.zeros(()))
        y = torch.einsum("bijh,bjhp->bihp", _bf16_terms(weighted, terms),
                         xf[:, sl])
        y = y + torch.exp(hi + lo)[..., None] * torch.einsum(
            "bin,bhpn->bihp", Cf[:, sl], _bf16_terms(h, terms))
        h = torch.exp(hi[:, -1] + lo[:, -1])[..., None, None] * h + own
        ys.append(y)
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


def _split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int,
                  acc=None) -> torch.Tensor:
    """``acc + a @ b`` as the kernels take it: k-slices of 8 in order, each
    the sum of lo.hi, hi.lo and hi.hi (``terms`` 3) or of hi.hi alone
    (``terms`` 1), added into an fp32 accumulator."""
    out = (torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None
           else acc)
    for k0 in range(0, a.shape[-1], 8):
        x, y = a[..., k0:k0 + 8], b[..., k0:k0 + 8, :]
        xh, yh = _tf32(x), _tf32(y)
        if terms == 3:
            out = out + _tf32(x - xh) @ yh
            out = out + xh @ _tf32(y - yh)
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


def _bf16_product(a: torch.Tensor, b: torch.Tensor, split: bool,
                  acc=None) -> torch.Tensor:
    """``acc + a @ b`` as the bf16 kernel takes it: bf16 operands (b is
    exact in bf16), k-slices of 16 in order, each added into an fp32
    accumulator; with ``split`` the fp32 ``a`` runs as bf16 hi and lo, lo
    first."""
    hi = _bf16(a)
    terms = [_bf16(a - hi), hi] if split else [hi]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:]) if acc is None else acc
    for k0 in range(0, a.shape[-1], 16):
        for t in terms:
            out = out + t[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return out


def _bf16_route_backward(q, k, v, do, causal, window, split_p: bool,
                         split_ds: bool, fp32_o: bool) -> tuple:
    """The bf16 backward kernel's arithmetic on the CPU: S and dP from the
    bf16 operands in fp32, P rebuilt from the forward's row log-sum-exp,
    delta = rowsum(dO o O) from the fp32 O (``fp32_o``) or the bf16 one, P
    (in dV) and dS (in dK and dQ) split into bf16 hi and lo or rounded to
    bf16 alone, dK and dV summed over a GQA group in head order in fp32.
    Returns bf16 (dq, dk, dv)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    scale = D ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    keep = _mask(S, causal, window)
    s = _bf16_product(qf, kf.transpose(-1, -2), False) * scale
    s = torch.where(keep, s, torch.tensor(-1e30))
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.where(keep, torch.exp(s - lse), torch.zeros(()))
    o = p @ vf
    delta = (dof * (o if fp32_o else _bf16(o))).sum(-1, keepdim=True)
    ds = p * (_bf16_product(dof, vf.transpose(-1, -2), False) - delta)
    dq = _bf16_product(ds, kf, split_ds) * scale
    dk = _bf16_product(ds.transpose(-1, -2), qf, split_ds) * scale
    dv = _bf16_product(p.transpose(-1, -2), dof, split_p)
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


# (split_p, split_ds, fp32_o): the kernel's design first, then each of the
# roundings it rejects.
BF16_BWD_DESIGNS = {"split_fp32_o": (True, True, True),
                    "bf16_o": (True, True, False),
                    "bf16_p": (False, True, True),
                    "bf16_ds": (True, False, True)}


@pytest.mark.parametrize("design", sorted(BF16_BWD_DESIGNS))
@pytest.mark.parametrize("case", [BACKWARD_BF16_TRAIN_CASE, RAGGED_CASES[2]],
                         ids=case_id)
def test_bf16_backward_rounding_meets_limits_only_as_designed(case, design):
    """dq, dk and dv with the bf16 backward's rounding against jax.grad of
    the JAX model's attention: with P and dS split and delta from the fp32
    O, each within BACKWARD_BF16_LIMIT and BACKWARD_BF16_RMS_LIMIT (and
    MAIN_RMS_LIMIT); with any one of them rounded as the bf16 forward's
    output is, some gradient outside the rms limit."""
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
