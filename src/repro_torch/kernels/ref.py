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
    Scores in fp32, masked with -1e30, softmax in fp32.  k and v are
    widened before they are repeated over the group, so that under
    autograd each of a group's query heads adds its share to dK and dV in
    fp32 and the sum is rounded to the input's dtype once, as the JAX
    model's ``flash_attention_jnp`` contracts the group in fp32 (repeated
    in bf16, each share would round to bf16 before the sum: 2.6e-3 of dK's
    rms at group 7).
    """
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    k = k.float().repeat_interleave(group, dim=1)
    v = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * (D ** -0.5)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return out.to(q.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None) -> tuple:
    """The plain backward: (dq, dk, dv) of ``sum(flash_attention_ref(q, k,
    v) * do)`` by ``torch.autograd.grad`` through the fully materialised
    forward above.  Shapes as the forward's, ``do`` like q; each gradient
    in its input's dtype: for bf16 inputs the fp32 gradient rounded to bf16
    once, the gradient the JAX model takes of its ``flash_attention_jnp``
    (``src/repro/models/attention.py``), which casts q, k and v to fp32."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(out, leaves, grad_outputs=do)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         index, *, window: Optional[int] = None
                         ) -> torch.Tensor:
    """One-token attention against a cache, fully materialised.

    q: [B, Hq, D]; k, v: [B, Hkv, S, D]; ``index`` (an int or a 0-d
    tensor) is the newest valid slot: slots past it, and with a window
    slots at or before ``index - window``, are masked with -1e30.
    Computed in fp64 and rounded to fp32, then to q's dtype: two fp32
    versions that sum in different orders round about one bf16 output in
    a few thousand to different sides, and in fp64 they agree to ~1e-15.
    Returns [B, Hq, D] in q's dtype.
    """
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    group = Hq // Hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.double(), k.double()) * (D ** -0.5)
    kp = torch.arange(S, device=q.device)
    mask = kp <= index
    if window is not None:
        mask &= kp > index - window
    s = torch.where(mask[None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", p, v.double())
    return out.float().to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor) -> tuple:
    """Token-by-token linear recurrence (independent of the chunked form).

    x: [b, S, H, P]; dt: [b, S, H]; A: [H]; B, C: [b, S, N].
    h_t = h_{t-1} * exp(dt_t A) + dt_t x_t (x) B_t ;  y_t = h_t . C_t
    Returns (y [b, S, H, P] in x's dtype, final state [b, H, P, N] in
    fp32); the state is carried in fp32.
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    Af = A.float()
    h = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af[None, :])                   # [b, H]
        h = (h * dA[..., None, None]
             + torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                            Bf[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                     dstate: Optional[torch.Tensor] = None) -> tuple:
    """The plain backward: (dx, ddt, dA, dB, dC) of ``sum(y * dy) +
    sum(state * dstate)`` for ``(y, state) = ssd_scan_ref(x, dt, A, B,
    C)``, by ``torch.autograd.grad`` through the token recurrence above.
    ``dy`` is like x, ``dstate`` (fp32 ``[b, H, P, N]``) may be None (no
    gradient reaches the final state); each gradient in its input's dtype
    (the fp32 gradient rounded once)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
        y, state = ssd_scan_ref(*leaves)
        outs, cots = [y], [dy]
        if dstate is not None:
            outs.append(state)
            cots.append(dstate)
        return torch.autograd.grad(outs, leaves, grad_outputs=cots)
