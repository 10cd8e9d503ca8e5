"""Dispatch between the port's kernels and their plain versions.

``impl`` selection, mirroring the JAX package's ``kernels/ops.py``:
  * "cuda" -- the hand-written kernel; raises unless the tensors are on a
              CUDA device (never falls back)
  * "ref"  -- the plain PyTorch version, on any device
  * "auto" -- the kernel for CUDA tensors, the plain version for CPU ones
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels.ref import flash_attention_ref

IMPLS = ("cuda", "ref", "auto")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D]."""
    if impl == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if impl == "cuda" and q.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors; q is on "
                         f"{q.device}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return _fa.flash_attention(q, k, v, causal=causal, window=window)
