"""Model assembly: embeddings + stacked blocks + head.

Mirrors ``Model.init_params``, ``forward``, ``init_cache``, ``prefill``
and ``decode_step`` of the JAX package's ``models/model.py`` for every
family (``loss`` comes with training).  Parameters
are a nested dict with the JAX pytree's layout: ``{"embed": {"table"},
"blocks": {...stacked...}, "final_norm": {"scale"}, "head": {"w"}}``; the
cache is a nested dict stacked ``[num_blocks, ...]`` the same way.
Unlike the JAX versions, ``prefill`` and ``decode_step`` update the cache
in place (and return it).
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
        with ``seed`` (the JAX package's distributions and scales; the
        Mamba2 and router leaves that JAX keeps in fp32 stay fp32 whatever
        ``dtype``).  Embedding-input models keep a token table too, for
        decode."""
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

    @staticmethod
    def _embed_in(params: Dict, tokens: Optional[torch.Tensor],
                  embeds: Optional[torch.Tensor]) -> torch.Tensor:
        return embeds if embeds is not None else embed(params["embed"],
                                                       tokens)

    def forward(self, params: Dict, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None) -> tuple:
        """tokens [B, S] (or embeds [B, S, d]) -> (logits [B, S, vocab],
        router stats summed over blocks as 0-d fp32 tensors: ``aux_loss``,
        ``router_z``, ``dropped_frac``; zero without an MoE sublayer)."""
        x = self._embed_in(params, tokens, embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        stats = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                 for k in blk.ZERO_STATS}
        for i in range(self.cfg.num_blocks):
            x, st = blk.block_forward(blk.block_params(params["blocks"], i),
                                      self.cfg, x, positions)
            stats = {k: stats[k] + st[k] for k in stats}
        x = rms_norm(x, params["final_norm"]["scale"], self.cfg.rms_eps)
        return unembed(params["head"], x), stats

    # -- decode path -----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device: Union[str, torch.device] = "cuda") -> Dict:
        """Zeroed decode cache: KV slots for attention sublayers, conv
        window and SSM state for Mamba2 sublayers."""
        return blk.init_stacked_cache(self.cfg, batch, max_len, dtype,
                                      resolve_device(device))

    def prefill(self, params: Dict, tokens: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, impl: str = "auto") -> tuple:
        """tokens [B, S] (or embeds [B, S, d]): a full-sequence pass
        filling ``cache`` (from :meth:`init_cache`, in place); returns
        (last-position logits [B, 1, vocab], cache).  ``impl`` picks the
        blocks' kernels (K1 for attention, K3 for the SSD scan)."""
        x = self._embed_in(params, tokens, embeds)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        for i in range(self.cfg.num_blocks):
            x, _ = blk.block_prefill(blk.block_params(params["blocks"], i),
                                     self.cfg, x, positions,
                                     blk.block_params(cache, i), impl)
        x = rms_norm(x[:, -1:], params["final_norm"]["scale"],
                     self.cfg.rms_eps)
        return unembed(params["head"], x), cache

    def decode_step(self, params: Dict, tokens: torch.Tensor, cache: Dict,
                    index: Union[int, torch.Tensor],
                    impl: str = "auto") -> tuple:
        """tokens [B, 1] at position ``index`` (an int or a 0-d int32
        tensor) -> (logits [B, 1, vocab], cache updated in place).
        ``impl`` picks the attention (K2)."""
        x = embed(params["embed"], tokens)
        index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
        for i in range(self.cfg.num_blocks):
            x, _ = blk.block_decode(blk.block_params(params["blocks"], i),
                                    self.cfg, x, blk.block_params(cache, i),
                                    index, impl)
        x = rms_norm(x, params["final_norm"]["scale"], self.cfg.rms_eps)
        return unembed(params["head"], x), cache
