"""The port's flash attention (plain version on the CPU) against the JAX
package's Pallas kernel in interpret mode and its jnp oracle."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    FLASH_CASES,
    RAGGED_CASES,
    case_id,
    tolerance,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# The slow interpret-mode comparison runs on these FLASH_CASES; the rest use
# the ref.
INTERPRET = {1, 3, 5, 6}


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


@pytest.mark.parametrize("case", RAGGED_CASES,
                         ids=case_id)
def test_flash_attention_ragged_sequence(case):
    B, Hq, Hkv, S, D, causal, window, dtype = case
    (jq, jk, jv), (q, k, v) = _inputs(B, Hq, Hkv, S, D, dtype, seed=1)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = jax_ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tolerance(dtype))


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


@pytest.mark.parametrize("bad", ["shape", "heads", "window"])
def test_wrapper_rejects_bad_inputs(bad):
    (_, _, _), (q, k, v) = _inputs(1, 4, 2, 64, 64, "float32")
    if bad == "shape":
        k = k[:, :, :32]
    elif bad == "heads":
        q = q[:, :3]
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0 if bad == "window" else None)
