"""GQA attention: the full-sequence (prefill / encoder) path and the
one-token decode path against a KV cache.

Mirrors ``init_attention``, ``_project_qkv``, ``attention_forward``,
``init_kv_cache`` and ``attention_decode`` of the JAX package's
``models/attention.py``.  Where JAX calls its jnp ``flash_attention_jnp``,
the port calls :func:`repro_torch.kernels.ops.flash_attention`, and for a
decoded token :func:`repro_torch.kernels.ops.decode_attention`: the Hopper
kernels on CUDA, the plain versions on the CPU.  The projections and the
cache stay ``[B, S, H, D]``; the kernels read them through strides as
``[B, H, S, D]``, and K1 writes its output so that the merge of the heads
before ``wo`` is a free reshape.
"""
from __future__ import annotations

from typing import Union

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


def _forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, impl: str) -> tuple:
    """Full-sequence attention: (out [B, S, d], k, v [B, S, nkv, h])."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=cfg.causal,
                              window=cfg.sliding_window, impl=impl)
    out = out.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], k, v


def attention_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor,
                      impl: str = "auto") -> torch.Tensor:
    """Full-sequence attention over x: [B, S, d].

    ``impl`` picks the attention (``ops.flash_attention``): the default
    runs the kernel on CUDA and the plain version on the CPU; ``"ref"``
    forces the plain version (the card's check of a whole block uses it).
    """
    return _forward(params, cfg, x, positions, impl)[0]


def attention_prefill(params: dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, cache: dict,
                      impl: str = "auto") -> tuple:
    """Full-sequence attention that also writes k/v into slots
    ``[0, S)`` of ``cache`` (in place).  Returns (out, cache)."""
    out, k, v = _forward(params, cfg, x, positions, impl)
    S = x.shape[1]
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    return out, cache


# ---------------------------------------------------------------------------
# Decode path (single new token against a KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device="cuda", lead: tuple = ()) -> dict:
    shape = lead + (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, index: Union[int, torch.Tensor],
                     impl: str = "auto") -> tuple:
    """x: [B, 1, d]; index: position of the new token (an int or a 0-d
    int32 tensor on x's device).

    Returns (out [B, 1, d], cache).  Unlike the JAX version, which returns
    a new cache, the new token's k/v are written into slot ``index`` of
    ``cache`` in place.  The sliding-window variant attends only to the
    last ``window`` slots by masking.  ``impl`` picks the attention
    (``ops.decode_attention``).
    """
    B = x.shape[0]
    idx = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, idx.expand(B, 1))
    slot = idx.reshape(1).long()
    cache["k"].index_copy_(1, slot, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v_new.to(cache["v"].dtype))
    out = ops.decode_attention(q[:, 0], cache["k"].transpose(1, 2),
                               cache["v"].transpose(1, 2), idx,
                               window=cfg.sliding_window, impl=impl)
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim)
    return out @ params["wo"], cache
