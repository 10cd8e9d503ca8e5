"""Wrapper of the Hopper flash-attention kernels.

The port's counterpart of the JAX package's Pallas kernel
``kernels/flash_attention.py::flash_attention``: same signature and
layout (q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]``), same masks and
arithmetic.  Tensors on the CPU go to the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); CUDA tensors launch
a kernel or raise.  Two routes, by dtype:

* bf16 -- ``csrc/flash_attention_bf16.cu``: both products on the tensor
  cores (``wgmma``), K/V streamed by TMA; D % 8 == 0 (TMA's stride rule);
* fp32 -- ``csrc/flash_attention.cu``: the products on the fp32 CUDA cores
  (TF32 cannot hold the fp32 limit); D % 4 == 0.

``flash_attention.launches`` counts every kernel launch,
``tensor_core_launches`` and ``cuda_core_launches`` those of each route.

Unlike the Pallas kernel, any ``S`` is taken (the kernels mask the ragged
last tile), and q/k/v may be strided views: only the head-dim stride must
be 1, so the model hands over its ``[B, S, H, D]`` projections transposed
in place, with no copy.  The output is allocated with q's strides.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 128


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Hq,S,D], k/v [B,Hkv,S,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, S, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[1] == 0 or Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    multiple = 8 if q.dtype == torch.bfloat16 else 4
    if D > MAX_HEAD_DIM or D % multiple:
        raise ValueError(f"head dim {D} unsupported for {q.dtype}: the "
                         f"kernels take D <= {MAX_HEAD_DIM} with D % "
                         f"{multiple} == 0")


# dtype -> (library, entry point, launch counter); both entry points take
# the same arguments.
_ROUTES = {
    torch.bfloat16: ("flash_attention_bf16", "odin_flash_attention_bf16_fwd",
                     "tensor_core_launches"),
    torch.float32: ("flash_attention", "odin_flash_attention_fwd",
                    "cuda_core_launches"),
}


def _entry(name: str, entry: str) -> tuple:
    """(library, entry point) of ``csrc/<name>.cu``, built and typed."""
    lib = build.load(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.odin_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odin_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int]) -> torch.Tensor:
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ROUTES:
        raise TypeError(f"the kernels take float32 or bfloat16 q/k/v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, S, D = q.shape
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a head-dim stride of 1")
    name, entry, counter = _ROUTES[q.dtype]
    if q.dtype == torch.bfloat16:      # TMA's rule
        build.check_copy_strides("the bf16 kernel", q, k, v)
    out = torch.empty_like(q)      # keeps q's strides (dense views)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)))
    lib, fn = _entry(name, entry)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, k.shape[1], S, D, ctypes.addressof(strides),
            int(causal), int(window or 0), float(D ** -0.5), stream)
    if err < 0:
        raise RuntimeError(f"flash_attention ({name}): TMA descriptor could "
                           f"not be built: CUresult {-err}")
    if err:
        msg = lib.odin_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel ({name}) launch failed: "
                           f"CUDA error {err} ({msg})")
    flash_attention.launches += 1
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D].

    CPU tensors run the plain version; CUDA tensors run the kernel.
    """
    _check_shapes(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0
flash_attention.tensor_core_launches = 0
flash_attention.cuda_core_launches = 0
