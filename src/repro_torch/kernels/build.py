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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence

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


def build_kernels(names: Sequence[str]) -> Dict[str, Optional[str]]:
    """:func:`build_kernel` for each name, with one ``nvcc`` per source,
    all started together.  Raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(build_kernel, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_kernel(name)
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
