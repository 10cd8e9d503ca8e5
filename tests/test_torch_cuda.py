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
    FLASH_CASES,
    MAIN_CASES,
    MAIN_RMS_LIMIT,
    MAIN_TOLERANCE,
    RAGGED_CASES,
    case_id,
    tolerance,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


def _inputs(shapes, dtype: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device="cuda", dtype=getattr(torch, dtype)) for s in shapes]


def _to_card(tree: dict) -> dict:
    return {k: _to_card(v) if isinstance(v, dict) else v.cuda()
            for k, v in tree.items()}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + RAGGED_CASES, ids=case_id)
def test_kernel_matches_plain_version(card, case):
    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    n = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="cuda")
    torch.cuda.synchronize()
    assert flash_attention.launches == n + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **tolerance(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", MAIN_CASES, ids=case_id)
def test_kernel_matches_plain_version_at_main_path_shape(card, case):
    B, Hq, Hkv, S, D, causal, window, dtype = case
    q, k, v = _inputs([(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)], dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="cuda").float()
    want = flash_attention_ref(q, k, v, causal=causal, window=window).float()
    torch.testing.assert_close(got, want, **MAIN_TOLERANCE)
    rms_err = float((got - want).square().mean().sqrt())
    assert rms_err <= MAIN_RMS_LIMIT * float(want.square().mean().sqrt())


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
        want = Model(cfg).forward(params, tokens)
        n = flash_attention.launches
        got = Model(cfg).forward(_to_card(params), tokens.cuda())
    assert flash_attention.launches == n + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


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
            blk.block_forward(bp, cfg, x, pos),
            blk.block_forward(bp, cfg, x, pos, attn_impl="ref"),
            atol=1e-4, rtol=1e-4)
