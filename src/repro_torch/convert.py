"""Weight bridge from the JAX package's parameters to the port's.

The JAX parameters arrive as a nested dict of numpy arrays (the caller
runs ``jax.tree.map(np.asarray, params)``); both packages use the same
nested layout with block leaves stacked ``[num_blocks, ...]``, so the
bridge is a leaf-by-leaf copy.  The leaves that the JAX init holds in fp32
whatever the model's dtype stay fp32: Mamba2's ``A_log``, ``D`` and
``dt_bias``, and the MoE ``router``.
"""
from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from repro_torch.models import mamba2, moe
from repro_torch.util.device import resolve_device

#: Leaves kept in fp32 whatever the model's dtype, as the JAX inits keep
#: them.
FP32_LEAVES = mamba2.FP32_LEAVES | moe.FP32_LEAVES


def params_from_jax(tree: Mapping, dtype=torch.float32,
                    device: Union[str, torch.device] = "cuda") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    in ``dtype`` (fp32 for the leaves named in ``FP32_LEAVES``)."""
    dev = resolve_device(device)

    def leaf(a, name) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, dtype=np.float32))   # a copy
        return t.to(device=dev, dtype=torch.float32
                    if name in FP32_LEAVES else dtype)

    def walk(node, name=None):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        return leaf(node, name)

    return walk(tree)
