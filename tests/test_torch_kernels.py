"""The port's kernels (plain versions on the CPU) against the JAX
package's Pallas kernels in interpret mode and its jnp oracles: flash
attention (K1), decode attention (K2) and the SSD scan (K3)."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
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
    flash_attention_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import mamba2 as port_mamba  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
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
