"""Shared layer primitives on plain tensors (params are nested dicts).

Mirrors the JAX package's ``models/layers.py``: the same arithmetic and
the same initial distributions, drawn from an explicit
:class:`torch.Generator` instead of ``jax.random`` (the numbers differ;
tests take their weights from the JAX package through
:func:`repro_torch.convert.params_from_jax`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Upcast to fp32, normalise, apply an fp32 scale, cast back."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * scale.float()).to(x.dtype)


def init_rms_norm(dim: int, dtype=torch.float32, device="cuda",
                  lead: tuple = ()) -> dict:
    return {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device)}


def init_normal(gen: torch.Generator, shape: tuple, std: float, dtype,
                device) -> torch.Tensor:
    """Normal(0, std) drawn from ``gen`` in place into the leaf: no
    temporary, so a stacked leaf of tens of GB (llava-next-34b's MLP, the
    experts of deepseek-moe-16b) needs only its own memory."""
    w = torch.empty(shape, dtype=dtype, device=device)
    return w.normal_(0.0, std, generator=gen)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotation.  x: [..., S, H, D]; positions: [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # [D/2]
    angles = positions[..., :, None, None].float() * freqs        # [..,S,1,D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32, device="cuda", lead: tuple = ()) -> dict:
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "wi": init_normal(gen, lead + (d_model, d_ff), s_in, dtype, device),
        "wg": init_normal(gen, lead + (d_model, d_ff), s_in, dtype, device),
        "wo": init_normal(gen, lead + (d_ff, d_model), s_out, dtype, device),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["wi"]
    g = x @ params["wg"]
    return (F.silu(g) * h) @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32, device="cuda") -> dict:
    return {"table": init_normal(gen, (vocab, d_model), d_model ** -0.5,
                                 dtype, device)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def init_unembed(gen: torch.Generator, d_model: int, vocab: int,
                 dtype=torch.float32, device="cuda") -> dict:
    return {"w": init_normal(gen, (d_model, vocab), d_model ** -0.5, dtype,
                             device)}


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]
