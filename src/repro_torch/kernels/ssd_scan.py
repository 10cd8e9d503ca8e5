"""Wrapper of the Hopper SSD chunk-scan kernel (``csrc/ssd_scan.cu``) and
of its backward (``csrc/ssd_scan_bwd.cu``).

The port's counterpart of the JAX package's Pallas kernel
``kernels/ssd_scan.py::ssd_scan``: same layout (x ``[b, S, H, P]``, dt
``[b, S, H]``, A ``[H]``, B/C ``[b, S, N]``).  Tensors on the CPU go to
the plain version (:func:`repro_torch.kernels.ref.ssd_scan_ref`, which
autograd differentiates); CUDA tensors launch the kernel or raise.
``ssd_scan.launches`` counts calls that launched it.

The kernel is chunk-parallel: the chunk states, the recurrence over
chunks and the chunk outputs are three launches of one call
(:func:`launch_shape` gives their grids), with the products on the
tensor cores: ``mma.sync`` m16n8k16 for bf16 inputs (fp32 operands in
three bf16 terms), m16n8k8 with TF32 operands for fp32 ones (every product
as lo.hi + hi.lo + hi.hi, "3xTF32").

Where an input requires grad under grad mode the call goes through
``_SsdScanFn``: its forward is the same kernel, keeping the forward's
scratch (the cumulative dA and the state entering each chunk), and its
backward the hand-written backward kernel (five launches,
:func:`backward_launch_shape`; its products on the tensor cores, m16n8k8
with TF32 operands for both dtypes, 3xTF32 where both operands are fp32),
counted once a call in ``ssd_scan.backward_launches``.  The JAX package's
Pallas kernel has no backward: JAX differentiates its jnp
``ssd_chunked``, and this is that gradient.

Unlike the Pallas kernel it returns the final state ``[b, H, P, N]`` in
fp32 beside y (the model's prefill keeps it), takes any ``S`` and chunk
(a short last chunk is masked), and reads strided views: only the last
dimension's stride must be 1 (the strides of x, B and C multiples of 16
bytes, for ``cp.async``), so the model hands over its x, B and C as views
into the conv output, with no copy.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_scan_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64      # P
MAX_STATE = 128        # N
TILE = 64              # positions per row tile of the output launch


def _check_shapes(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int) -> None:
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"expected x [b,S,H,P], B/C [b,S,N]; got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}")
    b, S, H, _ = x.shape
    if (tuple(dt.shape) != (b, S, H) or tuple(A.shape) != (H,)
            or tuple(B.shape[:2]) != (b, S) or C.shape != B.shape):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not match "
                         f"x {tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.odin_ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.odin_ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.odin_ssd_scan_smem_bytes.restype = ctypes.c_int
        lib.odin_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odin_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = build.load("ssd_scan_bwd")
    fn = lib.odin_ssd_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for query in (lib.odin_ssd_scan_bwd_smem_bytes,
                      lib.odin_ssd_scan_bwd_blocks_per_sm):
            query.argtypes = [ctypes.c_int] * 2
            query.restype = ctypes.c_int
        lib.odin_cuda_error_string.argtypes = [ctypes.c_int]
        lib.odin_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch_shape(b: int, S: int, H: int, P: int, N: int, chunk: int,
                 dtype: torch.dtype) -> dict:
    """The three launches of one call: name -> (grid, threads per block,
    dynamic shared memory in bytes)."""
    chunk = min(chunk, S)
    nc, tiles = math.ceil(S / chunk), math.ceil(chunk / TILE)
    smem = _library().odin_ssd_scan_smem_bytes
    return {"ssd_chunk_states": ((nc, H, b), 256, smem(0, _DTYPES[dtype])),
            "ssd_state_pass": ((math.ceil(P * N / 256), H, b), 256, 0),
            "ssd_chunk_outputs": ((tiles * nc, H, b), 256,
                                  smem(2, _DTYPES[dtype]))}


def backward_launch_shape(b: int, S: int, H: int, P: int, N: int,
                          chunk: int, dtype: torch.dtype = torch.float32
                          ) -> dict:
    """The five launches of one backward call: name -> (grid, threads per
    block, dynamic shared memory in bytes).  The first is skipped when the
    sequence is one chunk; the tile launch runs three blocks (du, dB, row)
    per (64-position tile, chunk, head, batch)."""
    chunk = min(chunk, S)
    nc, tiles = math.ceil(S / chunk), math.ceil(chunk / TILE)
    lib = _bwd_library()

    def smem(which: int) -> int:
        return lib.odin_ssd_scan_bwd_smem_bytes(which, _DTYPES[dtype])

    shapes = {"ssd_bwd_chunk_dstates": ((nc - 1, H, b), 256, smem(0)),
              "ssd_bwd_state_pass": ((math.ceil(P * N / 256), H, b), 256, 0),
              "ssd_bwd_tiles": ((3 * tiles * nc, H, b), 256, smem(2)),
              "ssd_bwd_chunk_finish": ((nc, H, b), 256, 0),
              "ssd_bwd_sums": ((math.ceil(max(b * S * N, H) / 256),), 256,
                               0)}
    if nc == 1:
        del shapes["ssd_bwd_chunk_dstates"]
    return shapes


def backward_blocks_per_sm(dtype: torch.dtype) -> dict:
    """Blocks of the backward's launch 1 and tile launch that fit one SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), by launch name."""
    lib = _bwd_library()
    out = {}
    for which, name in ((0, "ssd_bwd_chunk_dstates"), (2, "ssd_bwd_tiles")):
        n = lib.odin_ssd_scan_bwd_blocks_per_sm(which, _DTYPES[dtype])
        _raise_on(lib, max(-n, 0), "occupancy query of the backward")
        out[name] = n
    return out


def _check_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor) -> None:
    ts = (x, dt, A, B, C)
    if any(t.device != x.device for t in ts):
        raise ValueError("x, dt, A, B and C must lie on one device")
    if any(t.dtype != x.dtype for t in ts) or x.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16 inputs of one "
                        f"dtype; got {[t.dtype for t in ts]}")
    b, S, H, P = x.shape
    N = B.shape[-1]
    multiple = 16 // x.element_size()
    if P > MAX_HEAD_DIM or P % multiple or N > MAX_STATE or N % multiple:
        raise ValueError(f"P={P}, N={N} unsupported for {x.dtype}: the "
                         f"kernel takes P <= {MAX_HEAD_DIM} and N <= "
                         f"{MAX_STATE}, both multiples of {multiple}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("x, dt, A, B and C need a last-dimension stride "
                         "of 1")
    build.check_copy_strides("the kernel's x, B and C", x, B, C)


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        msg = lib.odin_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, chunk: int) -> tuple:
    """One forward call: (y, final state, cs, states), the last two the
    scratch that the backward reads."""
    _check_inputs(x, dt, A, B, C)
    b, S, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    y = torch.empty((b, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    # Scratch: the cumulative dA (an fp32 hi, lo pair per position), and
    # each chunk's state (then the state entering it).
    cs = torch.empty((b, H, S, 2), dtype=torch.float32, device=x.device)
    states = torch.empty((b, math.ceil(S / chunk), H, P, N),
                         dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 13)(
        *(x.stride(i) for i in (0, 1, 2)), *(dt.stride(i) for i in (0, 1, 2)),
        *(B.stride(i) for i in (0, 1)), *(C.stride(i) for i in (0, 1)),
        *(y.stride(i) for i in (0, 1, 2)))
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.odin_ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr(), cs.data_ptr(),
            states.data_ptr(), b, S, H, P, N, chunk,
            ctypes.addressof(strides), _DTYPES[x.dtype], stream)
    _raise_on(lib, err, "ssd_scan kernel")
    ssd_scan.launches += 1
    return y, state, cs, states


def backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, cs: torch.Tensor,
             states: torch.Tensor, dy: Optional[torch.Tensor],
             dstate: Optional[torch.Tensor], *, chunk: int = 256) -> tuple:
    """(dx, ddt, dA, dB, dC) of the scan from its inputs, the forward's
    scratch ``cs`` and ``states`` (the last two items of one forward call
    with this ``chunk``), the gradient ``dy`` of y and ``dstate`` of the
    final state (fp32; None counts as zero, as does a None ``dy``): one
    call of ``csrc/ssd_scan_bwd.cu`` (five launches, four when S is one
    chunk), counted in ``ssd_scan.backward_launches``.  Each gradient is
    contiguous, in its input's dtype.  A ``dy`` that ``cp.async`` cannot
    copy as it lies (a last stride that is not 1, as an expanded gradient
    has, or rows that are not 16-byte aligned) is copied once."""
    _check_shapes(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"the backward kernel takes CUDA tensors; got "
                         f"{x.device}")
    _check_inputs(x, dt, A, B, C)
    b, S, H, P = x.shape
    N = B.shape[-1]
    chunk = min(chunk, S)
    nc = math.ceil(S / chunk)
    dev = x.device
    if dy is None:
        dy = torch.zeros_like(x)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != dev:
        raise ValueError(f"dy must be like x {tuple(x.shape)} {x.dtype}; got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if dy.stride(-1) != 1 or not build.copy_aligned(dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
    if dstate is not None:
        if (tuple(dstate.shape) != (b, H, P, N)
                or dstate.dtype != torch.float32 or dstate.device != dev):
            raise ValueError(f"dstate must be fp32 {(b, H, P, N)} on {dev}; "
                             f"got {tuple(dstate.shape)} {dstate.dtype}")
        dstate = dstate.contiguous()
    if (cs.dtype != torch.float32 or tuple(cs.shape) != (b, H, S, 2)
            or not cs.is_contiguous() or states.dtype != torch.float32
            or tuple(states.shape) != (b, nc, H, P, N)
            or not states.is_contiguous()):
        raise ValueError("cs and states must be the forward's contiguous "
                         "fp32 scratch for this shape and chunk")
    f32 = dict(dtype=torch.float32, device=dev)
    g = torch.empty((b, nc, H, P, N), **f32)
    # Per position: r, the column sum of s and w, w, x . du, then the rows'
    # partial sums of s over each key tile.
    part = torch.empty((b, H, S, 4 + math.ceil(chunk / TILE)),
                       dtype=torch.float64, device=dev)
    dBh = torch.empty((b, H, S, N), **f32)
    dCh = torch.empty((b, H, S, N), **f32)
    da_part = torch.empty((b, nc, H), dtype=torch.float64, device=dev)
    dx, ddt, dA, dB, dC = (torch.empty(shape, dtype=x.dtype, device=dev)
                           for shape in ((b, S, H, P), (b, S, H), (H,),
                                         (b, S, N), (b, S, N)))
    strides = (ctypes.c_longlong * 13)(
        *(x.stride(i) for i in (0, 1, 2)), *(dt.stride(i) for i in (0, 1, 2)),
        *(B.stride(i) for i in (0, 1)), *(C.stride(i) for i in (0, 1)),
        *(dy.stride(i) for i in (0, 1, 2)))
    lib = _bwd_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.odin_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), dy.data_ptr(), cs.data_ptr(), states.data_ptr(),
            None if dstate is None else dstate.data_ptr(), g.data_ptr(),
            part.data_ptr(), dBh.data_ptr(), dCh.data_ptr(),
            da_part.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), b, S, H, P, N, chunk,
            ctypes.addressof(strides), _DTYPES[x.dtype], stream)
    _raise_on(lib, err, "ssd_scan backward kernel")
    ssd_scan.backward_launches += 1
    return dx, ddt, dA, dB, dC


def forward_for_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, *,
                         chunk: int = 256) -> tuple:
    """CUDA inputs -> (y, final state, cs, states): one forward launch,
    with the scratch that :func:`backward` takes."""
    _check_shapes(x, dt, A, B, C, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors; got {x.device}")
    return _launch(x, dt, A, B, C, chunk)


class _SsdScanFn(torch.autograd.Function):
    """K3 with its gradient: the forward kernel, saving its scratch, and
    the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        y, state, cs, states = _launch(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C, cs, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, cs, states = ctx.saved_tensors
        grads = backward(x, dt, A, B, C, cs, states, dy, dstate,
                         chunk=ctx.chunk)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256) -> tuple:
    """x [b, S, H, P], dt [b, S, H], A [H], B/C [b, S, N] ->
    (y [b, S, H, P] in x's dtype, final state [b, H, P, N] in fp32).

    CPU tensors run the plain version (which has no chunks); CUDA tensors
    run the kernel with chunks of ``min(chunk, S)`` positions, and where an
    input requires grad under grad mode go through ``_SsdScanFn``, whose
    backward is the backward kernel.
    """
    _check_shapes(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        return _SsdScanFn.apply(x, dt, A, B, C, chunk)
    return _launch(x, dt, A, B, C, chunk)[:2]


ssd_scan.launches = 0
ssd_scan.backward_launches = 0
