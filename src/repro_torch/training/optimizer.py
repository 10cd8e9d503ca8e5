"""Hand-rolled AdamW on nested dicts of tensors.

Mirrors the JAX package's ``training/optimizer.py`` formula for formula:
state ``{m, v, count}`` mirrors the params; master math in fp32 whatever
the param dtype; the gradient is clipped by its global norm; bias
correction uses ``count + 1``; decoupled weight decay is added to the step
before ``lr`` scales it; each new leaf is cast back to its param's dtype.
Like the JAX version it returns new dicts and leaves its inputs as they
are.  (``torch.optim.AdamW`` decays the weights and adds epsilon in
another order.)  Everything stays on the params' device: the norm, the
clip scale and the learning rate are 0-d tensors, so a step does not wait
on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.util.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(c: AdamWConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup + cosine decay, as a 0-d fp32 tensor (on ``step``'s
    device where it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(c.warmup_steps, 1)
    prog = torch.clamp((step - c.warmup_steps)
                       / max(c.total_steps - c.warmup_steps, 1), 0, 1)
    cos = c.min_lr_frac + (1 - c.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return c.lr * torch.where(step < c.warmup_steps, warm, cos)


def init_adamw(params: Dict) -> Dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32,
                             device=leaves(params)[0].device),
    }


def global_norm(tree: Dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw_update(c: AdamWConfig, params: Dict, grads: Dict, state: Dict
                 ) -> Tuple[Dict, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {grad_norm, lr})."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(c, count)
    count_f = count.to(torch.float32)
    bc1 = 1 - c.b1 ** count_f
    bc2 = 1 - c.b2 ** count_f

    def upd(p, g, m, v):
        g = g.float() * scale
        m = c.b1 * m + (1 - c.b1) * g
        v = c.b2 * v + (1 - c.b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + c.eps)
        step = step + c.weight_decay * p.float()
        new_p = p.float() - lr * step
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                           for i in range(3))
    new_state = {"m": new_m, "v": new_v, "count": count}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}

