"""Plain PyTorch versions of the port's kernels (independent formulations).

Each mirrors the oracle of the same name in the JAX package's
``kernels/ref.py``: the CPU path of the kernel wrappers runs them, and the
card's check holds each kernel against them on the same inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Naive full-materialisation softmax attention.

    q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D] in q's dtype.
    Scores in fp32, masked with -1e30, softmax in fp32.
    """
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (D ** -0.5)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
