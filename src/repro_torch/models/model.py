"""Model assembly: embeddings + stacked blocks + head.

Mirrors ``Model.init_params`` and ``Model.forward`` of the JAX package's
``models/model.py``.  Parameters are a nested dict with the JAX pytree's
layout: ``{"embed": {"table"}, "blocks": {...stacked...},
"final_norm": {"scale"}, "head": {"w"}}``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    embed,
    init_embedding,
    init_rms_norm,
    init_unembed,
    rms_norm,
    unembed,
)
from repro_torch.util.device import resolve_device


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def init_params(self, seed: int = 0, dtype=torch.float32,
                    device: Union[str, torch.device] = "cuda") -> Dict:
        """Random parameters drawn on ``device`` from a generator seeded
        with ``seed`` (the JAX package's distributions and scales)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cfg = self.cfg
        return {
            "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype,
                                    dev),
            "blocks": blk.init_stacked_blocks(gen, cfg, dtype, dev),
            "final_norm": init_rms_norm(cfg.d_model, dtype, dev),
            "head": init_unembed(gen, cfg.d_model, cfg.vocab_size, dtype, dev),
        }

    def forward(self, params: Dict, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] (or embeds [B, S, d]) -> logits [B, S, vocab]."""
        x = embeds if embeds is not None else embed(params["embed"], tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        for i in range(self.cfg.num_blocks):
            x = blk.block_forward(blk.block_params(params["blocks"], i),
                                  self.cfg, x, positions)
        x = rms_norm(x, params["final_norm"]["scale"], self.cfg.rms_eps)
        return unembed(params["head"], x)
