"""Wrapper of the Hopper SSD chunk-scan kernel (``csrc/ssd_scan.cu``).

The port's counterpart of the JAX package's Pallas kernel
``kernels/ssd_scan.py::ssd_scan``: same layout (x ``[b, S, H, P]``, dt
``[b, S, H]``, A ``[H]``, B/C ``[b, S, N]``).  Tensors on the CPU go to
the plain version (:func:`repro_torch.kernels.ref.ssd_scan_ref`); CUDA
tensors launch the kernel or raise.  ``ssd_scan.launches`` counts calls
that launched it.

The kernel is chunk-parallel: the chunk states, the recurrence over
chunks and the chunk outputs are three launches of one call
(:func:`launch_shape` gives their grids), with the products on the
tensor cores for bf16 inputs (fp32 operands split into bf16 hi and lo)
and on the CUDA cores for fp32 ones.

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


def _launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, chunk: int) -> tuple:
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
    if err:
        msg = lib.odin_cuda_error_string(err).decode()
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"({msg})")
    ssd_scan.launches += 1
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256) -> tuple:
    """x [b, S, H, P], dt [b, S, H], A [H], B/C [b, S, N] ->
    (y [b, S, H, P] in x's dtype, final state [b, H, P, N] in fp32).

    CPU tensors run the plain version (which has no chunks); CUDA tensors
    run the kernel with chunks of ``min(chunk, S)`` positions.
    """
    _check_shapes(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan for device {x.device}")
    return _launch(x, dt, A, B, C, chunk)


ssd_scan.launches = 0
