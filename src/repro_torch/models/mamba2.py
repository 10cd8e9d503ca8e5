"""Mamba2 block: SSD (state-space duality) chunked forward + recurrent decode.

Mirrors the JAX package's ``models/mamba2.py`` (the discrete SSD form of
arXiv:2405.21060, ``n_groups = 1``).  Where JAX's :func:`mamba_forward`
calls the jnp ``ssd_chunked``, the port calls
:func:`repro_torch.kernels.ops.ssd_scan`: the Hopper kernel on CUDA, the
plain token recurrence on the CPU.  :func:`ssd_chunked` is kept as the JAX
model's own chunked form, which the tests hold to JAX's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import init_normal, rms_norm

#: Leaves that the JAX ``init_mamba`` keeps in fp32 whatever the model's
#: dtype (the SSM's decay, skip and step bias).
FP32_LEAVES = frozenset({"A_log", "D", "dt_bias"})


# ---------------------------------------------------------------------------
# Core SSD math
# ---------------------------------------------------------------------------


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k]
    (lower-triangular; -inf above the diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan in the chunked (dual) form.

    x: [b, S, H, P]; dt: [b, S, H] (post-softplus); A: [H] (negative);
    B, C: [b, S, N].  Returns (y [b, S, H, P], final_state [b, H, P, N]).
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    nc = S // chunk

    xb = x.reshape(b, nc, chunk, H, P)
    dtb = dt.reshape(b, nc, chunk, H)
    Bb = B.reshape(b, nc, chunk, N)
    Cb = C.reshape(b, nc, chunk, N)

    dA = (dtb * A).movedim(-1, -2)                      # [b,nc,H,cs]
    dA_cs = torch.cumsum(dA, dim=-1)                   # [b,nc,H,cs]

    # 1. Intra-chunk (diagonal block) output: quadratic dual form.
    L = torch.exp(segsum(dA))                          # [b,nc,H,cs,cs]
    cb = torch.einsum("bcin,bcjn->bcij", Cb, Bb)       # [b,nc,cs,cs]
    xdt = xb * dtb[..., None]                          # [b,nc,cs,H,P]
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", cb, L, xdt)

    # 2. Chunk states: decayed sum of B (x) x within each chunk.
    decay_states = torch.exp(dA_cs[..., -1:] - dA_cs)  # [b,nc,H,cs]
    states = torch.einsum("bchl,bcln,bclhp->bchpn", decay_states, Bb, xdt)

    # 3. Inter-chunk recurrence, in fp32.
    chunk_decay = torch.exp(dA_cs[..., -1]).float()    # [b,nc,H]
    state = (init_state.float() if init_state is not None
             else torch.zeros((b, H, P, N), dtype=torch.float32,
                              device=x.device))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c].float()
    prev_states = torch.stack(prev, dim=1)             # [b,nc,H,P,N]

    # 4. Inter-chunk (off-diagonal) output: read the previous state.
    state_decay = torch.exp(dA_cs)                     # [b,nc,H,cs]
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", Cb,
                         prev_states.to(x.dtype), state_decay)

    y = (y_diag + y_off).reshape(b, S, H, P)
    return y, state.to(x.dtype)


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.

    x: [b, H, P]; dt: [b, H]; B, C: [b, N]; state: [b, H, P, N].
    h' = h * exp(dt A) + dt * x (x) B ;  y = h' . C
    """
    dA = torch.exp(dt * A[None, :])                    # [b,H]
    xdt = x * dt[..., None]                            # [b,H,P]
    new_state = (state * dA[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xdt, B))
    y = torch.einsum("bhpn,bn->bhp", new_state, C)
    return y, new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block (projections + conv + SSD + gated norm)
# ---------------------------------------------------------------------------


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device="cuda", lead: tuple = ()) -> dict:
    """The JAX ``init_mamba``'s leaves, distributions and scales, with
    ``A_log``, ``D`` and ``dt_bias`` in fp32 whatever ``dtype``."""
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    H = s.num_heads(d)
    N = s.d_state
    cd = din + 2 * N
    sc = d ** -0.5
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return {
        "wz": init_normal(gen, lead + (d, din), sc, dtype, device),
        "wx": init_normal(gen, lead + (d, din), sc, dtype, device),
        "wB": init_normal(gen, lead + (d, N), sc, dtype, device),
        "wC": init_normal(gen, lead + (d, N), sc, dtype, device),
        "wdt": init_normal(gen, lead + (d, H), sc, dtype, device),
        "conv_w": init_normal(gen, lead + (s.d_conv, cd),
                              (s.d_conv * cd) ** -0.5, dtype, device),
        "conv_b": torch.zeros(lead + (cd,), dtype=dtype, device=device),
        "A_log": a_log.expand(lead + (H,)).contiguous(),
        "D": torch.ones(lead + (H,), **f32),
        "dt_bias": torch.zeros(lead + (H,), **f32),
        "norm_scale": torch.ones(lead + (din,), dtype=dtype, device=device),
        "out_proj": init_normal(gen, lead + (din, d), din ** -0.5, dtype,
                                device),
    }


def _project(params: dict, x: torch.Tensor):
    """x: [B, S, d] -> z, xBC (pre-conv), dt."""
    z = x @ params["wz"]
    xs = x @ params["wx"]
    Bm = x @ params["wB"]
    Cm = x @ params["wC"]
    dt = x @ params["wdt"]
    return z, torch.cat([xs, Bm, Cm], dim=-1), dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d.  xBC: [B, S, Cd]; w: [K, Cd].

    ``init``: [B, K-1, Cd] left context.  Written as the JAX version
    writes it, a sum of K shifted slices times ``w[i]`` (not a cuDNN
    convolution, which would run fp32 in TF32 on the card).
    """
    K, S = w.shape[0], xBC.shape[1]
    if init is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[-1]))
    else:
        pad = init.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                 # [B, S+K-1, Cd]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _chunk(chunk_size: int, S: int) -> int:
    """The JAX model's chunk: min(chunk_size, S), halved until it divides
    S (its ``ssd_chunked`` needs that)."""
    chunk = min(chunk_size, S)
    while S % chunk:
        chunk //= 2
    return chunk


def scan_inputs(params: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple:
    """x: [B, S, d] -> (z, pre-conv xBC, and the SSD scan's inputs x
    [B, S, H, P], dt [B, S, H], A [H], B and C [B, S, N], in x's dtype)."""
    s = cfg.ssm
    B_, S, d = x.shape
    din = s.d_inner(d)
    N = s.d_state

    z, xBC_pre, dt = _project(params, x)
    xBC = F.silu(_causal_conv(xBC_pre, params["conv_w"], params["conv_b"]))
    xs = xBC[..., :din].reshape(B_, S, s.num_heads(d), s.head_dim)  # views
    Bm = xBC[..., din:din + N]
    Cm = xBC[..., din + N:]
    dt = F.softplus(dt.float() + params["dt_bias"]).to(x.dtype)
    A = (-torch.exp(params["A_log"])).to(x.dtype)
    return z, xBC_pre, xs, dt, A, Bm, Cm


def _mixer(params: dict, cfg: ModelConfig, x: torch.Tensor, impl: str):
    """The full-sequence Mamba2 mixer: (out [B, S, d], pre-conv xBC,
    final SSM state [B, H, P, N] in fp32)."""
    B_, S, d = x.shape
    z, xBC_pre, xs, dt, A, Bm, Cm = scan_inputs(params, cfg, x)
    # The kernel masks a short last chunk, so the config's chunk goes as it
    # is (the JAX rule would give an odd S chunks of one token); the plain
    # token recurrence ignores it.
    y, state = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm.chunk_size,
                            impl=impl)
    y = y + xs * params["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B_, S, cfg.ssm.d_inner(d))
    y = rms_norm(y * F.silu(z), params["norm_scale"], cfg.rms_eps)
    return y @ params["out_proj"], xBC_pre, state


def mamba_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                  impl: str = "auto") -> torch.Tensor:
    """Train/prefill forward.  x: [B, S, d] -> [B, S, d].

    ``impl`` picks the SSD scan (``ops.ssd_scan``): the default runs the
    kernel on CUDA and the plain version on the CPU.
    """
    return _mixer(params, cfg, x, impl)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device="cuda",
                     lead: tuple = ()) -> dict:
    s = cfg.ssm
    din = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, din + 2 * s.d_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, H, s.head_dim, s.d_state),
                           dtype=dtype, device=device),
    }


def mamba_decode(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: dict) -> tuple:
    """x: [B, 1, d] -> ([B, 1, d], cache).

    Unlike the JAX version, which returns a new cache, this updates
    ``cache`` in place and returns it.
    """
    s = cfg.ssm
    B_, _, d = x.shape
    din = s.d_inner(d)
    N = s.d_state
    H = s.num_heads(d)
    P = s.head_dim

    z, xBC, dt = _project(params, x)
    # conv over the cached window + current token
    window = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)  # [B,K,Cd]
    conv_out = (torch.einsum("bkc,kc->bc", window, params["conv_w"])
                + params["conv_b"])[:, None, :]
    xBC = F.silu(conv_out)

    xs = xBC[..., :din].reshape(B_, H, P)
    Bm = xBC[:, 0, din:din + N]
    Cm = xBC[:, 0, din + N:]
    dtv = F.softplus(dt[:, 0].float() + params["dt_bias"]).to(x.dtype)
    A = (-torch.exp(params["A_log"])).to(x.dtype)
    y, new_ssm = ssd_step(xs, dtv, A, Bm, Cm, cache["ssm"])
    y = y + xs * params["D"].to(x.dtype)[None, :, None]
    y = y.reshape(B_, 1, din)
    y = rms_norm(y * F.silu(z), params["norm_scale"], cfg.rms_eps)
    out = y @ params["out_proj"]
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(new_ssm)
    return out, cache
