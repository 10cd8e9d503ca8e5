"""Weight bridge from the JAX package's parameters to the port's.

The JAX parameters arrive as a nested dict of numpy arrays (the caller
runs ``jax.tree.map(np.asarray, params)``); both packages use the same
nested layout with block leaves stacked ``[num_blocks, ...]``, so the
bridge is a leaf-by-leaf copy.
"""
from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from repro_torch.util.device import resolve_device


def params_from_jax(tree: Mapping, dtype=torch.float32,
                    device: Union[str, torch.device] = "cuda") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    in ``dtype``."""
    dev = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, dtype=np.float32))   # a copy
        return t.to(device=dev, dtype=dtype)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return leaf(node)

    return walk(tree)
