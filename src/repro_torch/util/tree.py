"""Nested dicts of tensors as trees: the port's ``jax.tree`` helpers."""
from __future__ import annotations

from typing import Callable, Dict, List

import torch


def leaves(tree: Dict) -> List[torch.Tensor]:
    """The leaves of a nested dict, keys sorted at every level (the order
    of ``jax.tree.leaves``)."""
    out = []
    for key in sorted(tree):
        node = tree[key]
        out.extend(leaves(node) if isinstance(node, dict) else [node])
    return out


def tree_map(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``:
    a new nested dict."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
