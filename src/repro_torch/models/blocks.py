"""Block (pipeline-unit) definitions.

Mirrors the JAX package's ``models/blocks.py``: a *block* is the
homogeneous super-layer the pipeline scheduler moves between stages --
dense/moe/vlm/audio → one attention sublayer; ssm → one Mamba2 sublayer;
hybrid (Jamba) → the period-8 super-block (1 attn + 7 mamba), MoE on
alternating sublayers.  Every sublayer is pre-norm:  x += Mixer(LN(x));
x += FFN(LN(x)), where the FFN is a SwiGLU MLP, an MoE or (ssm) none.
Blocks expose three modes:

* ``block_forward``   — full sequence (serving / prefill compute)
* ``block_prefill``   — full sequence + fills the decode cache
* ``block_decode``    — one token + cache -> one token + cache

Parameters and caches of all blocks are stacked along a leading
``num_blocks`` axis (the JAX pytree's layout), so a pipeline stage runs
blocks ``[lo, hi)`` by index.  Unlike the JAX versions, which return new
caches, ``block_prefill`` and ``block_decode`` update the cache in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import init_mlp, init_rms_norm, mlp, rms_norm

ZERO_STATS = dict(aux_loss=0.0, router_z=0.0, dropped_frac=0.0)


def _sublayer_kinds(cfg: ModelConfig):
    """[(mixer_kind, ffn_kind)] per sublayer of one block."""
    out = []
    for i, mixer in enumerate(cfg.layer_pattern):
        if cfg.family == "ssm":
            ffn = "none"
        elif cfg.moe is not None and cfg.sublayer_is_moe(i):
            ffn = "moe"
        elif cfg.d_ff > 0:
            ffn = "dense"
        else:
            ffn = "none"
        out.append((mixer, ffn))
    return out


def init_stacked_blocks(gen: torch.Generator, cfg: ModelConfig,
                        dtype=torch.float32, device="cuda") -> Dict:
    """All blocks' parameters, each leaf stacked ``[num_blocks, ...]``."""
    lead = (cfg.num_blocks,)
    params = {}
    for i, (mixer, ffn) in enumerate(_sublayer_kinds(cfg)):
        sub = {"ln1": init_rms_norm(cfg.d_model, dtype, device, lead)}
        if mixer == "attn":
            sub["mixer"] = attn_lib.init_attention(gen, cfg, dtype, device,
                                                   lead)
        else:
            sub["mixer"] = mamba_lib.init_mamba(gen, cfg, dtype, device,
                                                lead)
        if ffn != "none":
            sub["ln2"] = init_rms_norm(cfg.d_model, dtype, device, lead)
        if ffn == "moe":
            sub["ffn"] = moe_lib.init_moe(gen, cfg.d_model, cfg.moe, dtype,
                                          device, lead)
        elif ffn == "dense":
            sub["ffn"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                  lead)
        params[f"sub{i}"] = sub
    return params


def init_block(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device="cuda") -> Dict:
    """One block's parameters (no leading axis)."""
    one = dataclasses.replace(cfg, num_layers=len(cfg.layer_pattern))
    return block_params(init_stacked_blocks(gen, one, dtype, device), 0)


def block_params(stacked: Dict, i: int) -> Dict:
    """Block ``i``'s parameters (or cache): views into the stacked leaves."""
    return {k: block_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _apply_ffn(sub: Dict, cfg: ModelConfig, ffn_kind: str, x: torch.Tensor):
    """Returns (delta, stats)."""
    if ffn_kind == "none":
        return None, ZERO_STATS
    h = rms_norm(x, sub["ln2"]["scale"], cfg.rms_eps)
    if ffn_kind == "moe":
        y, st = moe_lib.moe_forward(sub["ffn"], cfg.moe, h)
        return y, dict(aux_loss=st.aux_loss, router_z=st.router_z,
                       dropped_frac=st.dropped_frac)
    return mlp(sub["ffn"], h), ZERO_STATS


def block_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, impl: str = "auto") -> tuple:
    """Full-sequence application of one block; returns (x, summed router
    stats).  ``impl`` is passed to the mixer's kernel
    (``ops.flash_attention`` or ``ops.ssd_scan``).
    """
    stats = dict(ZERO_STATS)
    for i, (mixer, ffn) in enumerate(_sublayer_kinds(cfg)):
        sub = params[f"sub{i}"]
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        if mixer == "attn":
            x = x + attn_lib.attention_forward(sub["mixer"], cfg, h,
                                               positions, impl=impl)
        else:
            x = x + mamba_lib.mamba_forward(sub["mixer"], cfg, h, impl=impl)
        delta, st = _apply_ffn(sub, cfg, ffn, x)
        if delta is not None:
            x = x + delta
        stats = {k: stats[k] + st[k] for k in stats}
    return x, stats


# -- caches -------------------------------------------------------------------


def init_block_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device="cuda", lead: tuple = ()) -> Dict:
    """One block's decode cache (``lead`` prepends stacking axes)."""
    cache = {}
    for i, (mixer, _) in enumerate(_sublayer_kinds(cfg)):
        if mixer == "attn":
            cache[f"sub{i}"] = attn_lib.init_kv_cache(cfg, batch, max_len,
                                                      dtype, device, lead)
        else:
            cache[f"sub{i}"] = mamba_lib.init_mamba_cache(cfg, batch, dtype,
                                                          device, lead)
    return cache


def init_stacked_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                       device="cuda") -> Dict:
    """All blocks' decode caches, each leaf stacked ``[num_blocks, ...]``."""
    return init_block_cache(cfg, batch, max_len, dtype, device,
                            (cfg.num_blocks,))


def block_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, cache: Dict,
                  impl: str = "auto") -> tuple:
    """Full-sequence forward that also fills this block's decode cache (in
    place).  Returns (x, cache)."""
    for i, (mixer, ffn) in enumerate(_sublayer_kinds(cfg)):
        sub = params[f"sub{i}"]
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        if mixer == "attn":
            o, _ = attn_lib.attention_prefill(sub["mixer"], cfg, h, positions,
                                              cache[f"sub{i}"], impl=impl)
        else:
            o, mc = mamba_prefill(sub["mixer"], cfg, h, impl=impl)
            cache[f"sub{i}"]["conv"].copy_(mc["conv"])
            cache[f"sub{i}"]["ssm"].copy_(mc["ssm"])
        x = x + o
        delta, _ = _apply_ffn(sub, cfg, ffn, x)
        if delta is not None:
            x = x + delta
    return x, cache


def block_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict, index: Union[int, torch.Tensor],
                 impl: str = "auto") -> tuple:
    """One-token decode through one block (cache updated in place)."""
    for i, (mixer, ffn) in enumerate(_sublayer_kinds(cfg)):
        sub = params[f"sub{i}"]
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        if mixer == "attn":
            o, _ = attn_lib.attention_decode(sub["mixer"], cfg, h,
                                             cache[f"sub{i}"], index,
                                             impl=impl)
        else:
            o, _ = mamba_lib.mamba_decode(sub["mixer"], cfg, h,
                                          cache[f"sub{i}"])
        x = x + o
        delta, _ = _apply_ffn(sub, cfg, ffn, x)
        if delta is not None:
            x = x + delta
    return x, cache


# ---------------------------------------------------------------------------
# Mamba prefill helper (forward + cache extraction)
# ---------------------------------------------------------------------------


def mamba_prefill(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  impl: str = "auto") -> tuple:
    """Like ``mamba_forward`` but also returns the decode cache: the SSD
    scan's final state, and the last ``d_conv - 1`` pre-activation conv
    inputs (left-padded with zeros when ``S < d_conv - 1``)."""
    out, xBC_pre, state = mamba_lib._mixer(params, cfg, x, impl)
    K, S = cfg.ssm.d_conv, x.shape[1]
    if S >= K - 1:
        conv = xBC_pre[:, S - (K - 1):]
    else:
        conv = torch.nn.functional.pad(xBC_pre, (0, 0, K - 1 - S, 0))
    return out, {"conv": conv, "ssm": state}
