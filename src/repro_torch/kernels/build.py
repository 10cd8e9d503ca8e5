"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

``csrc/<name>.cu`` compiles into a shared library with a plain C
interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so <name>.cu

The library lands in ``build/kernels/`` at the repository root; its name
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is loaded as it is.  A source builds at first use
(:func:`load`), or ahead of it (:func:`build_kernels` runs one ``nvcc``
per source in parallel).  A failed build raises with ``nvcc``'s output;
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin; "
                           "the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return found


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_kernel(name: str) -> Optional[str]:
    """Compile ``csrc/<name>.cu`` unless its library is built already.

    Returns ``nvcc``'s output (ptxas prints registers and shared memory
    there), or None when there was nothing to build.
    """
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        str(CSRC / f"{name}.cu")],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc {name}\n{r.stdout}")
    os.replace(tmp, out)        # atomic: no half-written library
    return r.stdout


def _timed_build(name: str) -> Tuple[Optional[str], float]:
    t0 = time.perf_counter()
    out = build_kernel(name)
    return out, time.perf_counter() - t0


def build_kernels(names: Sequence[str]
                  ) -> Dict[str, Tuple[Optional[str], float]]:
    """:func:`build_kernel` for each name, with one ``nvcc`` per source,
    all started together: name -> (``nvcc``'s output or None, seconds).
    Raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(_timed_build, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def check_copy_strides(what: str, *tensors) -> None:
    """The kernels copy 16-byte pieces of rows (TMA, ``cp.async``): each
    tensor's base must be 16-byte aligned and every stride but the
    innermost (of a dimension longer than 1) a multiple of 16 bytes."""
    for t in tensors:
        per16 = 16 // t.element_size()
        if t.data_ptr() % 16 or any(t.stride(i) % per16
                                    for i in range(t.dim() - 1)
                                    if t.shape[i] > 1):
            raise ValueError(f"{what} needs 16-byte aligned tensors with "
                             f"strides that are multiples of {per16} "
                             f"elements; got strides {t.stride()}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernel(name)
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
