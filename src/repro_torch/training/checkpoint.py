"""NumPy checkpoints of nested dicts of tensors, in the JAX package's
format.

Mirrors the JAX package's ``training/checkpoint.py``: a tree is saved as
one flat ``step-<n>.npz`` whose keys are the leaves' paths as
``jax.tree_util.keystr`` writes them (``"['params']['blocks']['sub0']
['mixer']['wq']"``, ``"['opt']['count']"``), bf16 leaves widened to fp32,
written to a temporary file and renamed, with ``latest.json`` naming the
newest step.  So a checkpoint written by either package loads in the
other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path as ``jax.tree_util.keystr`` writes it: leaf}, keys sorted at
    every level (the order of ``jax.tree.leaves``)."""
    out = {}
    for key in sorted(tree):
        path = f"{prefix}[{key!r}]"
        node = tree[key]
        if isinstance(node, dict):
            out.update(flatten(node, path))
        else:
            out[path] = node
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:      # no numpy bf16: widen, as JAX does
        t = t.float()
    return t.numpy()


def save_checkpoint(path: str, tree: Any, step: int) -> None:
    os.makedirs(path, exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in flatten(tree).items()}
    tmp = os.path.join(path, f".tmp-{step}.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, os.path.join(path, f"step-{step}.npz"))
    with open(os.path.join(path, "latest.json"), "w") as f:
        json.dump({"step": step}, f)


def latest_step(path: str) -> int:
    try:
        with open(os.path.join(path, "latest.json")) as f:
            return json.load(f)["step"]
    except FileNotFoundError:
        return -1


def load_checkpoint(path: str, tree_like: Any, step: int = -1) -> Any:
    """Restore into the structure of ``tree_like``: each leaf a new tensor
    of its counterpart's shape, dtype and device."""
    if step < 0:
        step = latest_step(path)
        if step < 0:
            raise FileNotFoundError(f"no checkpoint under {path}")
    data = np.load(os.path.join(path, f"step-{step}.npz"))

    def restore(node: Dict, prefix: str) -> Dict:
        out = {}
        for key, leaf in node.items():
            p = f"{prefix}[{key!r}]"
            if isinstance(leaf, dict):
                out[key] = restore(leaf, p)
                continue
            arr = data[p]
            assert arr.shape == tuple(leaf.shape), (p, arr.shape, leaf.shape)
            out[key] = torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype)
        return out

    return restore(tree_like, "")
