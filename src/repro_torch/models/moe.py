"""Mixture-of-Experts FFN with top-k routing and capacity-buffer dispatch.

Mirrors the JAX package's ``models/moe.py``: tokens are split into groups
of a fixed size; within a group every (token, choice) pair claims a slot in
a per-expert capacity buffer by a cumulative count, and pairs past the
capacity are dropped for that expert (standard capacity-factor semantics).
Dispatch and combine are one-hot ``[T, E, C]`` tensors and everything
downstream is an einsum, in the model's dtype; the router's logits and
softmax are fp32 whatever the dtype.  DeepSeek-style *shared experts*
(always on, one wide SwiGLU) run beside the routed ones.  Returns the
routing statistics of the Switch load-balance loss.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import init_mlp, init_normal, mlp

#: Leaves that the JAX ``init_moe`` keeps in fp32 whatever the model's
#: dtype (the router: its math stays fp32).
FP32_LEAVES = frozenset({"router"})


def init_moe(gen: torch.Generator, d_model: int, m: MoEConfig,
             dtype=torch.float32, device="cuda", lead: tuple = ()) -> dict:
    """The JAX ``init_moe``'s leaves, distributions and scales, with the
    router in fp32 whatever ``dtype``."""
    s_in = d_model ** -0.5
    s_out = m.d_expert ** -0.5
    E = m.num_experts
    p = {
        "router": init_normal(gen, lead + (d_model, E), s_in, torch.float32,
                              device),
        "wi": init_normal(gen, lead + (E, d_model, m.d_expert), s_in, dtype,
                          device),
        "wg": init_normal(gen, lead + (E, d_model, m.d_expert), s_in, dtype,
                          device),
        "wo": init_normal(gen, lead + (E, m.d_expert, d_model), s_out, dtype,
                          device),
    }
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, d_model, m.num_shared_experts * m.d_shared,
                               dtype, device, lead)
    return p


@dataclasses.dataclass
class RouterStats:
    """Per-call routing statistics (0-d fp32 tensors)."""
    aux_loss: torch.Tensor       # Switch load-balance loss
    router_z: torch.Tensor       # mean squared logsumexp (z-loss term)
    dropped_frac: torch.Tensor   # fraction of (token, choice) pairs dropped


def capacity_per_group(group_tokens: int, m: MoEConfig) -> int:
    c = int(group_tokens * m.num_experts_per_tok * m.capacity_factor
            / m.num_experts)
    # round up to a multiple of 8 and keep >= 4
    return max(4, -(-c // 8) * 8)


def _route_group(xf: torch.Tensor, router: torch.Tensor, m: MoEConfig,
                 C: int):
    """The routing of each group -> dispatch/combine tensors.

    xf: [G, T, d] (the JAX version takes one group, [T, d], under
    ``vmap``).  Returns dispatch [G, T, E, C] (0/1), combine [G, T, E, C]
    (gate-weighted), all fp32, and per group f [G, E], pbar [G, E], zsum
    [G] and dropped [G].
    """
    G, T, _ = xf.shape
    E, K = m.num_experts, m.num_experts_per_tok
    logits = xf.float() @ router.float()                        # [G, T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, K, dim=-1)             # [G, T, K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    choice_oh = F.one_hot(expert_idx, E).float()                # [G,T,K,E]
    flat_oh = choice_oh.reshape(G, T * K, E)
    pos_in_expert = torch.cumsum(flat_oh, dim=1) - flat_oh      # [G,T*K,E]
    slot = (pos_in_expert * flat_oh).sum(-1).reshape(G, T, K)
    keep = (slot < C).float()                                   # [G, T, K]
    slot_oh = F.one_hot(slot.clamp(0, C - 1).long(), C).float()  # [G,T,K,C]
    slot_oh = slot_oh * keep[..., None]
    dispatch = torch.einsum("gtke,gtkc->gtec", choice_oh, slot_oh)
    combine = torch.einsum("gtke,gtkc->gtec", choice_oh * gate[..., None],
                           slot_oh)

    f = choice_oh.sum(2).mean(1)                                # [G, E]
    pbar = probs.mean(1)                                        # [G, E]
    zsum = torch.logsumexp(logits, dim=-1).square().mean(-1)    # [G]
    dropped = 1.0 - keep.mean((1, 2))                           # [G]
    return dispatch, combine, f, pbar, zsum, dropped


def _group_tokens(total: int, S: int, preferred: int) -> int:
    """Fixed token-group size: bounds the [Tg, E, C] dispatch tensor and
    the capacity variance.  Decode (S=1) degenerates to per-token groups
    (never drops)."""
    tg = min(preferred, S if S > 1 else 1)
    while total % tg:
        tg //= 2
    return max(tg, 1)


def moe_forward(params: dict, m: MoEConfig, x: torch.Tensor,
                group_size: int = 512) -> Tuple[torch.Tensor, RouterStats]:
    """x: [B, S, d] -> (y [B, S, d], stats)."""
    B, S, d = x.shape
    E = m.num_experts
    T = B * S
    Tg = _group_tokens(T, S, group_size)
    G = T // Tg
    C = capacity_per_group(Tg, m)
    xg = x.reshape(G, Tg, d)

    dispatch, combine, f, pbar, zsum, dropped = _route_group(
        xg, params["router"], m, C)

    buf = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)

    # Expert matmuls batched over groups: [G,E,C,d] x [E,d,f].
    h = torch.einsum("gecd,edf->gecf", buf, params["wi"])
    g = torch.einsum("gecd,edf->gecf", buf, params["wg"])
    y = torch.einsum("gecf,efd->gecd", F.silu(g) * h, params["wo"])

    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), y)
    out = out.reshape(B, S, d)

    if "shared" in params:
        out = out + mlp(params["shared"], x)

    # Switch aux loss over the whole call: E * sum_e mean(f_e)/K * mean(p_e)
    aux = E * torch.sum(f.mean(0) / m.num_experts_per_tok * pbar.mean(0))
    return out, RouterStats(aux_loss=aux, router_z=zsum.mean(),
                            dropped_frac=dropped.mean())
