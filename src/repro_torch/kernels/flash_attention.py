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

Gradients: on CUDA, inputs that require grad under grad mode go through
:class:`_FlashAttentionFn`.  Its forward launches the dtype's second entry
point, which also writes each row's log-sum-exp (``lse_launches`` counts
both dtypes', ``bf16_lse_launches`` the bf16 one's; the bf16 entry also
writes the fp32 output before its rounding, which the bf16 backward's
delta reads), and its backward launches ``csrc/flash_attention_bwd.cu``
(fp32) or ``csrc/flash_attention_bwd_bf16.cu`` (bf16;
``backward_launches`` counts both, ``bf16_backward_launches`` the bf16
one; a backward launch is not a forward one).  Nothing falls back to the
plain backward (``ref.flash_attention_bwd_ref``).  Inside
:func:`first_pass_of_checkpoint` -- the first pass of a non-reentrant
``torch.utils.checkpoint``, whose saved tensors are dropped and made again
by the recomputation -- the forward launches the first entry point and
saves unfilled tensors of the same shapes in place of the LSE entry's.

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


# dtype -> (the LSE entry point, its pointer arguments): fp32 q, k, v, o,
# lse; bf16 q, k, v, o, lse and the fp32 o.
_LSE_ENTRIES = {torch.float32: ("odin_flash_attention_fwd_lse", 5),
                torch.bfloat16: ("odin_flash_attention_bf16_fwd_lse", 6)}


def _lse_entry(dtype: torch.dtype) -> tuple:
    """(library, the dtype's LSE entry point), built and typed."""
    name, entry, _ = _ROUTES[dtype]
    lib, _ = _entry(name, entry)
    lse_entry, pointers = _LSE_ENTRIES[dtype]
    fn = getattr(lib, lse_entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


# dtype -> (the backward's source, its entry point, its tensors' strides).
_BWD_ROUTES = {
    torch.float32: ("flash_attention_bwd", "odin_flash_attention_bwd", 24),
    torch.bfloat16: ("flash_attention_bwd_bf16",
                     "odin_flash_attention_bwd_bf16", 21),
}


def _bwd_entry(dtype: torch.dtype) -> tuple:
    """(library, the dtype's backward entry point), built and typed."""
    name, entry, _ = _BWD_ROUTES[dtype]
    lib = build.load(name)
    fn = getattr(lib, entry)
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
            lse: Optional[torch.Tensor] = None,
            o32: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One forward launch; with ``lse`` (fp32 ``[B, Hq, S]``) the entry
    point that also writes each row's log-sum-exp, and for bf16 q/k/v the
    fp32 output into ``o32`` (fp32 ``[B, Hq, S, D]``, contiguous)."""
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
            lib, fn = _lse_entry(q.dtype)
            extra = (() if o32 is None else (o32.data_ptr(),))
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), *extra, *args, stream)
    _check_launch(lib, err, name)
    flash_attention.launches += 1
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    if lse is not None:
        flash_attention.lse_launches += 1
        if q.dtype == torch.bfloat16:
            flash_attention.bf16_lse_launches += 1
    return out


def forward_for_backward(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True,
                         window: Optional[int] = None) -> tuple:
    """fp32 or bf16 CUDA q/k/v -> (o, lse, o32): the forward, each row's
    log-sum-exp of its scaled scores, ``m + log(max(l, 1e-30))``, fp32
    ``[B, Hq, S]``, and the output in fp32, which :func:`backward` takes
    with ``lse``: for bf16 inputs the fp32 output before its rounding,
    which the bf16 entry writes too, for fp32 ``o`` itself.  One launch of
    the dtype's LSE entry point."""
    _check_shapes(q, k, v, window)
    if q.device.type != "cuda" or q.dtype not in _LSE_ENTRIES:
        raise ValueError(f"the LSE entry points take fp32 or bf16 CUDA "
                         f"tensors; got {q.dtype} on {q.device}")
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    o32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
           if q.dtype == torch.bfloat16 else None)
    out = _launch(q, k, v, causal, window, lse, o32)
    return out, lse, out if o32 is None else o32


def forward_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True,
                     window: Optional[int] = None) -> tuple:
    """fp32 or bf16 CUDA q/k/v -> (o, lse): the first two items of
    :func:`forward_for_backward`, from its one launch."""
    out, lse, _ = forward_for_backward(q, k, v, causal=causal,
                                       window=window)
    return out, lse


def backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None) -> tuple:
    """(dq, dk, dv) of the attention from its saved q, k, v, fp32 output
    ``o`` (the third item of :func:`forward_for_backward`) and
    ``lse`` and the output's gradient ``do``: one call of
    ``csrc/flash_attention_bwd.cu`` for fp32 q/k/v/do (three launches,
    four under GQA) or ``csrc/flash_attention_bwd_bf16.cu`` for bf16 (two
    launches, three under GQA), counted once in
    ``flash_attention.backward_launches``, and in
    ``bf16_backward_launches`` for bf16.  Each gradient has its input's
    dtype and strides."""
    _check_shapes(q, k, v, window)
    ts = (q, k, v, o, do)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError("the backward kernel takes CUDA tensors on one "
                         "device")
    dtype = q.dtype
    if (dtype not in _BWD_ROUTES or any(t.dtype != dtype for t in (k, v, do))
            or o.dtype != torch.float32 or lse.dtype != torch.float32):
        raise TypeError(f"the backward kernels take fp32 or bf16 q, k, v and "
                        f"do of one dtype with fp32 o and lse; got "
                        f"{[t.dtype for t in ts + (lse,)]}")
    bf16 = dtype == torch.bfloat16
    if do.stride(-1) != 1:
        do = do.contiguous()
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("q, k, v and o need a head-dim stride of 1")
    if tuple(lse.shape) != tuple(q.shape[:3]) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous {tuple(q.shape[:3])}; got "
                         f"{tuple(lse.shape)}")
    if bf16:                           # 16-byte copies of every row
        build.check_copy_strides("the bf16 backward kernel", q, k, v)
        try:
            build.check_copy_strides("the bf16 backward kernel", do)
        except ValueError:
            do = do.contiguous()
        if tuple(o.shape) != tuple(q.shape) or not o.is_contiguous():
            raise ValueError(f"o must be contiguous fp32 {tuple(q.shape)}")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    # Under GQA each query head's share of dK and dV, summed in head order.
    shares = torch.empty((2, Hq // Hkv, B, Hkv, S, D) if Hq > Hkv else (1,),
                         dtype=torch.float32, device=q.device)
    name, _, n_strides = _BWD_ROUTES[dtype]
    strided = ((q, k, v, do, dq, dk, dv) if bf16
               else (q, k, v, o, do, dq, dk, dv))
    strides = (ctypes.c_longlong * n_strides)(
        *(t.stride(i) for t in strided for i in (0, 1, 2)))
    lib, fn = _bwd_entry(dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 shares.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B, Hq, Hkv, S, D,
                 ctypes.addressof(strides), int(causal),
                 int(window or 0), float(D ** -0.5), stream)
    _check_launch(lib, err, name)
    flash_attention.backward_launches += 1
    if bf16:
        flash_attention.bf16_backward_launches += 1
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
    """K1 with its gradient: forward by the dtype's LSE entry point,
    backward by its backward kernel; fp32 or bf16 CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        if getattr(_PASS, "first", False):
            out = _launch(q, k, v, causal, window)
            # Dropped unread; the recomputation saves the same shapes.
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
            o32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
                   if q.dtype == torch.bfloat16 else out)
        else:
            out, lse, o32 = forward_for_backward(q, k, v, causal=causal,
                                                 window=window)
        ctx.save_for_backward(q, k, v, o32, lse)
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
        return _FlashAttentionFn.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0
flash_attention.tensor_core_launches = 0
flash_attention.fp32_launches = 0
flash_attention.lse_launches = 0
flash_attention.backward_launches = 0
flash_attention.bf16_lse_launches = 0
flash_attention.bf16_backward_launches = 0
