"""Wrapper of the Hopper decode-attention kernel
(``csrc/decode_attention.cu``).

The port's counterpart of the JAX package's Pallas kernel
``kernels/decode_attention.py::decode_attention``: same signature and
layout (q ``[B, Hq, D]``, k/v ``[B, Hkv, S, D]``, one ``index`` for the
batch), same masks and softmax, in fp64 where the Pallas kernel runs fp32
(the plain version is fp64 too, so the rounded outputs agree bit for bit
but where a value lies within ~1e-15 of a rounding boundary).  Tensors on
the CPU go to the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); CUDA tensors
launch the kernel or raise.  ``decode_attention.launches`` counts
calls that launched it (one launch a call).

The kernel runs one cluster of :data:`NSPLIT` blocks per (KV head, batch);
each block takes an equal share of the live slots, found on the card from
``index`` (:func:`split_ranges` is the same rule in Python), and the
cluster merges the shares through distributed shared memory.

Unlike the Pallas kernel, any ``S`` is taken, and k/v may be strided
views: only the head-dim stride must be 1 (every other stride a multiple
of 16 bytes, for ``cp.async``), so the model hands over its
``[B, S, Hkv, D]`` cache transposed in place, with no copy.  ``index`` may
be a Python int or a 0-d int32 tensor on the card; the kernel reads it
from device memory, so a decode loop that keeps it there never waits for
the host.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
#: Blocks (splits of the live slots) per (KV head, batch), launched as one
#: thread-block cluster: the kernel's compile-time NSPLIT.  16 is above the
#: portable 8 and is allowed explicitly; it was chosen by measurement, at
#: qwen3-4b's decode shape clusters of 16 ran faster than clusters of 8
#: (tools/k23_variants.py compiles and times both).
NSPLIT = 16


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Hq,D], k/v [B,Hkv,S,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, D = q.shape
    if (k.shape[0], k.shape[3]) != (B, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    multiple = 8 if q.dtype == torch.bfloat16 else 4
    if D > MAX_HEAD_DIM or D % multiple:
        raise ValueError(f"head dim {D} unsupported for {q.dtype}: the "
                         f"kernel takes D <= {MAX_HEAD_DIM} with D % "
                         f"{multiple} == 0 (16-byte rows)")


def split_ranges(index: int, S: int, window: Optional[int],
                 nsplit: int = NSPLIT) -> list:
    """The kernel's split of the live slots ``[max(0, index - window + 1),
    min(index, S - 1)]`` into ``nsplit`` shares of equal length (the last
    ones shorter or empty): ``[(start, end), ...]``, end exclusive."""
    hi = min(index, S - 1)
    lo = max(0, index - window + 1) if window else 0
    share = -(-max(hi - lo + 1, 0) // nsplit)
    return [(lo + s * share, min(lo + (s + 1) * share, hi + 1))
            for s in range(nsplit)]


def _library() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.odin_decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.odin_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odin_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            index: Union[int, torch.Tensor],
            window: Optional[int]) -> torch.Tensor:
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a head-dim stride of 1")
    build.check_copy_strides("the kernel's k and v", k, v)
    if isinstance(index, torch.Tensor):
        if index.numel() != 1 or index.dtype != torch.int32 \
                or index.device != q.device:
            raise ValueError(f"index must be one int32 on {q.device}; got "
                             f"{index.dtype} {tuple(index.shape)} on "
                             f"{index.device}")
        idx = index.reshape(1)
    else:
        idx = torch.full((1,), int(index), dtype=torch.int32,
                         device=q.device)
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *(k.stride(i) for i in (0, 1, 2)),
        *(v.stride(i) for i in (0, 1, 2)), out.stride(0), out.stride(1))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.odin_decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, S, D, ctypes.addressof(strides),
            int(window or 0), D ** -0.5, _DTYPES[q.dtype], stream)
    if err:
        msg = lib.odin_cuda_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} ({msg})")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     index: Union[int, torch.Tensor], *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Hq, D]; k, v: [B, Hkv, S, D]; index: the newest valid slot
    -> [B, Hq, D].

    CPU tensors run the plain version; CUDA tensors run the kernel.
    """
    _check_shapes(q, k, v, window)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, index, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {q.device}")
    return _launch(q, k, v, index, window)


decode_attention.launches = 0
