"""Dispatch between the port's kernels and their plain versions.

``impl`` selection, mirroring the JAX package's ``kernels/ops.py``:
  * "cuda" -- the hand-written kernel; raises unless the tensors are on a
              CUDA device (never falls back)
  * "ref"  -- the plain PyTorch version, on any device (differentiable
              by autograd; the card's gradient checks use it)
  * "auto" -- the kernel for CUDA tensors, the plain version for CPU ones
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import (
    decode_attention_ref,
    flash_attention_ref,
    ssd_scan_ref,
)

IMPLS = ("cuda", "ref", "auto")


def _check_impl(impl: str, t: torch.Tensor) -> None:
    if impl == "cuda" and t.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors; the input is on "
                         f"{t.device}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D]."""
    if impl == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_impl(impl, q)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     index: Union[int, torch.Tensor], *,
                     window: Optional[int] = None,
                     impl: str = "auto") -> torch.Tensor:
    """q: [B, Hq, D]; k, v: [B, Hkv, S, D]; index: newest valid slot
    -> [B, Hq, D]."""
    if impl == "ref":
        return decode_attention_ref(q, k, v, index, window=window)
    _check_impl(impl, q)
    return _da.decode_attention(q, k, v, index, window=window)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             impl: str = "auto") -> tuple:
    """x [b, S, H, P], dt [b, S, H], A [H], B/C [b, S, N] ->
    (y [b, S, H, P], final state [b, H, P, N] in fp32)."""
    if impl == "ref":
        return ssd_scan_ref(x, dt, A, B, C)
    _check_impl(impl, x)
    return _ssd.ssd_scan(x, dt, A, B, C, chunk=chunk)
