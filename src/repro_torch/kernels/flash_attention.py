"""Wrapper of the Hopper flash-attention kernels.

The port's counterpart of the JAX package's Pallas kernel
``kernels/flash_attention.py::flash_attention``: same signature and
layout (q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]``), same masks and
arithmetic.  Tensors on the CPU go to the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); CUDA tensors launch
a kernel or raise.  Two routes, by dtype:

* bf16 -- ``csrc/flash_attention_bf16.cu``: both products on the tensor
  cores (``wgmma``), K/V streamed by TMA; D % 8 == 0 (TMA's stride rule);
* fp32 -- ``csrc/flash_attention.cu``: both products on the tensor cores
  too (``mma.sync`` with TF32 operands), each fp32 operand split into TF32
  hi and lo and every product run as lo.hi + hi.lo + hi.hi ("3xTF32"),
  which carries about 22 bits where one TF32 product keeps 11 and misses
  the fp32 limit; D % 4 == 0.

``flash_attention.launches`` counts every forward launch,
``tensor_core_launches`` (bf16) and ``fp32_launches`` those of each route.

Gradients: on CUDA, fp32 inputs that require grad under grad mode go
through :class:`_FlashAttentionFn`.  Its forward launches the fp32 kernel's
second entry point, which also writes each row's log-sum-exp
(``lse_launches`` counts it), and its backward launches
``csrc/flash_attention_bwd.cu`` (``backward_launches``; a backward launch
is not a forward one).  bf16 inputs that require grad raise
``NotImplementedError``: the bf16 backward is a later item.  Nothing falls
back to the plain backward (``ref.flash_attention_bwd_ref``).  Inside
:func:`first_pass_of_checkpoint` -- the first pass of a non-reentrant
``torch.utils.checkpoint``, whose saved tensors are dropped and made again
by the recomputation -- the forward launches the first entry point and
saves an unfilled LSE of the same shape in its place.

Unlike the Pallas kernel, any ``S`` is taken (the kernels mask the ragged
last tile), and q/k/v may be strided views: only the head-dim stride must
be 1, so the model hands over its ``[B, S, H, D]`` projections transposed
in place, with no copy.  The output is allocated with q's strides.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 128
BF16_BACKWARD_ITEM = "ROADMAP Queue 1 item 13 (K1's bf16 backward)"


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
                    "fp32_launches"),
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


def _lse_entry() -> tuple:
    """(library, ``odin_flash_attention_fwd_lse``), built and typed."""
    lib, _ = _entry("flash_attention", "odin_flash_attention_fwd")
    fn = lib.odin_flash_attention_fwd_lse
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _bwd_entry() -> tuple:
    """(library, ``odin_flash_attention_bwd``) of
    ``csrc/flash_attention_bwd.cu``, built and typed."""
    lib = build.load("flash_attention_bwd")
    fn = lib.odin_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.odin_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odin_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check_launch(lib, err: int, name: str) -> None:
    if err < 0:
        raise RuntimeError(f"flash_attention ({name}): TMA descriptor could "
                           f"not be built: CUresult {-err}")
    if err:
        msg = lib.odin_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel ({name}) launch failed: "
                           f"CUDA error {err} ({msg})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int],
            lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One forward launch; with ``lse`` (fp32 ``[B, Hq, S]``, fp32 q/k/v
    only) the entry point that also writes each row's log-sum-exp."""
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
    args = (B, Hq, k.shape[1], S, D, ctypes.addressof(strides), int(causal),
            int(window or 0), float(D ** -0.5))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if lse is None:
            lib, fn = _entry(name, entry)
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     *args, stream)
        else:
            lib, fn = _lse_entry()
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), *args, stream)
    _check_launch(lib, err, name)
    flash_attention.launches += 1
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    if lse is not None:
        flash_attention.lse_launches += 1
    return out


def forward_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True,
                     window: Optional[int] = None) -> tuple:
    """fp32 CUDA q/k/v -> (o, lse): the forward and each row's
    log-sum-exp of its scaled scores, ``m + log(max(l, 1e-30))``, fp32
    ``[B, Hq, S]``.  One launch of the LSE entry point."""
    _check_shapes(q, k, v, window)
    if q.device.type != "cuda" or q.dtype != torch.float32:
        raise ValueError(f"forward_with_lse takes fp32 CUDA tensors; got "
                         f"{q.dtype} on {q.device}")
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _launch(q, k, v, causal, window, lse), lse


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None) -> tuple:
    """(dq, dk, dv) of the fp32 attention from its saved q, k, v, output
    ``o`` and ``lse`` and the output's gradient ``do``: one call of
    ``csrc/flash_attention_bwd.cu`` (three launches, four under GQA;
    counted once in ``flash_attention.backward_launches``).  Each gradient
    has its input's strides."""
    _check_shapes(q, k, v, window)
    ts = (q, k, v, o, do)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError("the backward kernel takes CUDA tensors on one "
                         "device")
    if any(t.dtype != torch.float32 for t in ts + (lse,)):
        raise TypeError(f"the backward kernel takes fp32 tensors; got "
                        f"{[t.dtype for t in ts + (lse,)]}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("q, k, v and o need a head-dim stride of 1")
    if tuple(lse.shape) != tuple(q.shape[:3]) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous {tuple(q.shape[:3])}; got "
                         f"{tuple(lse.shape)}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    # Under GQA each query head's share of dK and dV, summed in head order.
    shares = torch.empty((2, Hq // Hkv, B, Hkv, S, D) if Hq > Hkv else (1,),
                         dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(t.stride(i) for t in (q, k, v, o, do, dq, dk, dv) for i in (0, 1, 2)))
    lib, fn = _bwd_entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 shares.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, Hq, Hkv, S, D,
                 ctypes.addressof(strides), int(causal),
                 int(window or 0), float(D ** -0.5), stream)
    _check_launch(lib, err, "flash_attention_bwd")
    flash_attention.backward_launches += 1
    return dq, dk, dv


_PASS = threading.local()


@contextlib.contextmanager
def first_pass_of_checkpoint():
    """The first pass of a non-reentrant ``torch.utils.checkpoint``
    (pass it as the first context of ``context_fn``): K1's autograd forward
    need not write the LSE there, because checkpointing drops every
    tensor that pass saves and the recomputation, outside this context,
    saves the real one.  Thread-local: the recomputation runs on autograd's
    thread."""
    before = getattr(_PASS, "first", False)
    _PASS.first = True
    try:
        yield
    finally:
        _PASS.first = before


class _FlashAttentionFn(torch.autograd.Function):
    """K1 with its gradient: forward by the LSE entry point, backward by
    ``csrc/flash_attention_bwd.cu``; fp32 CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        if getattr(_PASS, "first", False):
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)        # dropped unread
            out = _launch(q, k, v, causal, window)
        else:
            out, lse = forward_with_lse(q, k, v, causal=causal,
                                        window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = backward(q, k, v, out, lse, do, causal=ctx.causal,
                              window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D].

    CPU tensors run the plain version; CUDA tensors run the kernel, and
    its backward kernel where an input requires grad under grad mode.
    """
    _check_shapes(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.dtype != torch.float32:
            raise NotImplementedError(
                f"flash_attention has no backward kernel for {q.dtype} on "
                f"CUDA yet ({BF16_BACKWARD_ITEM}); train in fp32, or run "
                f"under torch.no_grad() / torch.inference_mode()")
        return _FlashAttentionFn.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0
flash_attention.tensor_core_launches = 0
flash_attention.fp32_launches = 0
flash_attention.lse_launches = 0
flash_attention.backward_launches = 0
