"""Step functions + input specs for every (arch x input-shape) combination.

The port's counterpart of the JAX package's ``launch/steps.py``.  Where
JAX returns ``ShapeDtypeStruct`` stand-ins, these return tensors on the
meta device: shapes and dtypes with no storage behind them.  The steps
take the tensors they are given, so the same functions run on the meta
device (the dry run) and on a card.

* train:    {tokens|embeds, labels}                      -> metrics
* prefill:  {tokens|embeds}                              -> (logits, cache)
* decode:   {tokens, cache, index}                       -> (logits, cache)

The VLM/audio modality frontend is a stub: embedding inputs arrive
precomputed with shape [B, S, d_model].
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import (
    InputShape,
    ModelConfig,
    long_context_variant,
    shape_is_applicable,
)
from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.train_loop import make_train_step

PARAM_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16
META = torch.device("meta")


def resolve_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Apply the sanctioned long-context variant where required."""
    ok, why = shape_is_applicable(cfg, shape)
    if ok:
        return cfg
    if shape.name == "long_500k" and cfg.is_decoder:
        return long_context_variant(cfg)
    raise ValueError(f"{cfg.name} x {shape.name} not applicable: {why}")


def param_shapes(cfg: ModelConfig, dtype=PARAM_DTYPE) -> Dict:
    """The parameter tree on the meta device (the JAX tree's layout,
    dtypes and shapes)."""
    return Model(cfg).init_params(dtype=dtype, device=META)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype=PARAM_DTYPE) -> Dict[str, Any]:
    """Meta tensors for the step inputs (excluding params/opt)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "train":
        batch: Dict[str, Any] = {"labels": _spec((B, S), torch.int32)}
        if cfg.embedding_inputs:
            batch["embeds"] = _spec((B, S, cfg.d_model), dtype)
        else:
            batch["tokens"] = _spec((B, S), torch.int32)
        return {"batch": batch}
    if shape.mode == "prefill":
        if cfg.embedding_inputs:
            return {"embeds": _spec((B, S, cfg.d_model), dtype)}
        return {"tokens": _spec((B, S), torch.int32)}
    if shape.mode == "decode":
        cache = Model(cfg).init_cache(B, S, CACHE_DTYPE, device=META)
        return {"tokens": _spec((B, 1), torch.int32),
                "cache": cache,
                "index": _spec((), torch.int32)}
    raise ValueError(shape.mode)


def opt_state_shapes(params_sh: Dict) -> Dict:
    """AdamW's state for ``params_sh``, on their device (fp32 m and v)."""
    return init_adamw(params_sh)


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------


def make_train_step_fn(cfg: ModelConfig, opt: AdamWConfig = AdamWConfig(),
                       impl: str = "auto") -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    gradient of ``Model(cfg, remat=True).loss`` and one AdamW update."""
    return make_train_step(cfg, opt, remat=True, impl=impl)


def make_prefill_fn(cfg: ModelConfig, shape: InputShape,
                    impl: str = "auto") -> Callable:
    """Decoders: a cache of ``shape``'s length on the inputs' device,
    filled by ``Model.prefill`` -> (logits, cache).  Encoder-only archs
    (hubert): a full forward -> logits."""
    model = Model(cfg)
    B, S = shape.global_batch, shape.seq_len

    if cfg.is_decoder:
        @torch.inference_mode()
        def prefill(params, **inputs):
            x = inputs.get("tokens", inputs.get("embeds"))
            cache = model.init_cache(B, S, CACHE_DTYPE, device=x.device)
            return model.prefill(params, inputs.get("tokens"),
                                 inputs.get("embeds"), cache, impl=impl)
        return prefill

    @torch.inference_mode()
    def encode(params, **inputs):
        logits, _ = model.forward(params, inputs.get("tokens"),
                                  inputs.get("embeds"), impl=impl)
        return logits
    return encode


def make_decode_step_fn(cfg: ModelConfig, impl: str = "auto") -> Callable:
    """(params, tokens, cache, index) -> (logits, cache updated in place)."""
    model = Model(cfg)

    @torch.inference_mode()
    def decode_step(params, tokens, cache, index):
        return model.decode_step(params, tokens, cache, index, impl=impl)

    return decode_step
