"""Block (pipeline-unit) definitions for the attention-only families.

Mirrors ``_sublayer_kinds``, ``init_block``, ``init_stacked_blocks`` and
``block_forward`` of the JAX package's ``models/blocks.py``.  Every
sublayer is pre-norm:  x += Attn(LN(x));  x += MLP(LN(x)).  Parameters of
all blocks are stacked along a leading ``num_blocks`` axis (the JAX
pytree's layout), so a pipeline stage runs blocks ``[lo, hi)`` by index.

Mamba2 and MoE sublayers are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import init_mlp, init_rms_norm, mlp, rms_norm


def _sublayer_kinds(cfg: ModelConfig):
    """[(mixer_kind, ffn_kind)] per sublayer of one block."""
    if cfg.family == "ssm" or any(m != "attn" for m in cfg.layer_pattern):
        raise NotImplementedError(
            f"{cfg.name}: Mamba2 sublayers are not ported yet "
            "(ROADMAP.md Queue 1 item 8, Mamba2/Jamba)")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE sublayers are not ported yet "
            "(ROADMAP.md Queue 1 item 9)")
    ffn = "dense" if cfg.d_ff > 0 else "none"
    return [("attn", ffn)] * len(cfg.layer_pattern)


def init_stacked_blocks(gen: torch.Generator, cfg: ModelConfig,
                        dtype=torch.float32, device="cuda") -> Dict:
    """All blocks' parameters, each leaf stacked ``[num_blocks, ...]``."""
    lead = (cfg.num_blocks,)
    params = {}
    for i, (_, ffn) in enumerate(_sublayer_kinds(cfg)):
        sub = {"ln1": init_rms_norm(cfg.d_model, dtype, device, lead),
               "mixer": attn_lib.init_attention(gen, cfg, dtype, device,
                                                lead)}
        if ffn == "dense":
            sub["ln2"] = init_rms_norm(cfg.d_model, dtype, device, lead)
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
    """Block ``i``'s parameters: views into the stacked leaves."""
    return {k: block_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def block_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor,
                  attn_impl: str = "auto") -> torch.Tensor:
    """Full-sequence application of one block.

    The JAX version also returns summed MoE router statistics; with no MoE
    sublayer ported they are always zero, so only ``x`` is returned.
    ``attn_impl`` is passed to :func:`attention_forward`.
    """
    for i, (_, ffn) in enumerate(_sublayer_kinds(cfg)):
        sub = params[f"sub{i}"]
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        x = x + attn_lib.attention_forward(sub["mixer"], cfg, h, positions,
                                           impl=attn_impl)
        if ffn == "dense":
            h = rms_norm(x, sub["ln2"]["scale"], cfg.rms_eps)
            x = x + mlp(sub["ffn"], h)
    return x
