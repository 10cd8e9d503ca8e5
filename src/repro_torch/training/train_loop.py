"""Training loop: loss + grad + AdamW on one device.

Mirrors the JAX package's ``training/train_loop.py``: ``make_train_step``
builds a step that takes the gradient of ``Model.loss`` (blocks
rematerialised, as the JAX step's ``Model(cfg, remat=True)``) and applies
``adamw_update``; ``train`` runs it over a data iterator with the same
history keys, log line and checkpoint cadence.  The JAX loop's
``jax.jit`` has no counterpart: PyTorch runs the step eagerly, with K1's
forward and backward kernels for attention on CUDA.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update,
    init_adamw,
    leaves,
    tree_map,
)
from repro_torch.util.device import resolve_device


def loss_and_grads(model: Model, params: Dict, batch: Dict,
                   impl: str = "auto") -> tuple:
    """((loss, metrics), grads) of ``model.loss`` at ``params``, as
    ``jax.value_and_grad(model.loss, has_aux=True)`` gives them: grads is
    a nested dict like params (zeros for a leaf the loss does not reach,
    e.g. the token table of an embedding-input model).  ``params`` are
    left as they are (the gradient is taken through detached aliases)."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(live, batch, impl=impl)
        flat = leaves(live)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)}
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda p: by_leaf[id(p)], live)


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, remat: bool = True,
                    impl: str = "auto") -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    metrics of ``Model.loss`` plus ``grad_norm`` and ``lr``, 0-d tensors."""
    model = Model(cfg, remat=remat)

    def train_step(params, opt_state, batch):
        (_, metrics), grads = loss_and_grads(model, params, batch, impl)
        params, opt_state, opt_metrics = adamw_update(opt, params, grads,
                                                      opt_state)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def to_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``training/data.py``) on ``device``: integer
    arrays as int64 indices, float arrays (embeddings) in their own dtype,
    as the JAX loop's ``jnp.asarray`` keeps them.  fp32 embeddings against
    bf16 weights then run the blocks in fp32 (``models.layers.weight``),
    as JAX's type promotion does."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.to(device=device, dtype=(t.dtype if t.is_floating_point()
                                            else torch.int64))
    return out


def train(cfg: ModelConfig, opt: AdamWConfig, data_iter, num_steps: int,
          seed: int = 0, dtype=torch.float32,
          device: Union[str, torch.device] = "cuda", log_every: int = 10,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
          params=None, log_fn=print) -> Dict:
    """Train ``num_steps`` steps on batches of ``data_iter`` (dicts of
    numpy arrays).  Parameters come from ``Model.init_params(seed, dtype,
    device)`` unless given.  Returns {params, opt_state, history}: one
    history entry per logged step (every ``log_every`` and the last), with
    the step's metrics as floats, ``step``, and ``wall_s`` since the start,
    taken after the card has finished the step."""
    dev = resolve_device(device)
    model = Model(cfg, remat=True)
    if params is None:
        params = model.init_params(seed, dtype, dev)
    opt_state = init_adamw(params)
    step_fn = make_train_step(cfg, opt)

    history = []
    t_start = time.perf_counter()
    for step, batch in enumerate(data_iter):
        if step >= num_steps:
            break
        params, opt_state, metrics = step_fn(params, opt_state,
                                             to_batch(batch, dev))
        if step % log_every == 0 or step == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            m["wall_s"] = time.perf_counter() - t_start
            history.append(m)
            log_fn(f"step {step:5d} loss={m['loss']:.4f} ce={m['ce']:.4f} "
                   f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}")
        if checkpoint_dir and checkpoint_every and step and \
                step % checkpoint_every == 0:
            from repro_torch.training.checkpoint import save_checkpoint
            save_checkpoint(checkpoint_dir, {"params": params,
                                             "opt": opt_state}, step)
    return {"params": params, "opt_state": opt_state, "history": history}
