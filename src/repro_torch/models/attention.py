"""GQA attention, full-sequence (prefill / encoder) path.

Mirrors ``init_attention``, ``_project_qkv`` and ``attention_forward`` of
the JAX package's ``models/attention.py``.  Where JAX calls its jnp
``flash_attention_jnp``, the port calls :func:`repro_torch.kernels.ops.
flash_attention`: the Hopper kernel on CUDA, the plain version on the CPU.
The projections stay ``[B, S, H, D]``; the kernel reads them through
strides as ``[B, H, S, D]`` and writes its output so that the merge of the
heads before ``wo`` is a free reshape.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, init_normal, rms_norm


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype=torch.float32, device="cuda",
                   lead: tuple = ()) -> dict:
    d, h = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    s = d ** -0.5
    p = {
        "wq": init_normal(gen, lead + (d, nq * h), s, dtype, device),
        "wk": init_normal(gen, lead + (d, nkv * h), s, dtype, device),
        "wv": init_normal(gen, lead + (d, nkv * h), s, dtype, device),
        "wo": init_normal(gen, lead + (nq * h, d), (nq * h) ** -0.5, dtype,
                          device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros(lead + (n * h,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (h,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(lead + (h,), dtype=dtype, device=device)
    return p


def _project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x: [B, S, d] -> q [B,S,nq,h], k/v [B,S,nkv,h] (normed, roped)."""
    B, S, _ = x.shape
    h = cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.view(B, S, cfg.num_heads, h)
    k = k.view(B, S, cfg.num_kv_heads, h)
    v = v.view(B, S, cfg.num_kv_heads, h)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """Full-sequence attention over x: [B, S, d].

    ``impl`` picks the attention (``ops.flash_attention``): the default
    runs the kernel on CUDA and the plain version on the CPU; ``"ref"``
    forces the plain version (the card's check of a whole block uses it).
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=cfg.causal,
                              window=cfg.sliding_window, impl=impl)
    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"]
