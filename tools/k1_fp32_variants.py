"""Compile variants of K1's fp32 kernels and compare them on one card.

    python3 tools/k1_fp32_variants.py [--mma-rate] NAME:SOURCE[:FLAG...] ...

Each variant is a CUDA source with the C interface of
``src/repro_torch/kernels/csrc/flash_attention.cu`` (the forward: it
exports ``odin_flash_attention_fwd_lse``) or of
``csrc/flash_attention_bwd.cu`` (the backward), a path relative to the
repository's root, compiled by ``nvcc`` with the port's flags
(``repro_torch.kernels.build.NVCC_FLAGS``), ``-I`` the kernels' ``csrc/``
(for ``tf32_mma.cuh``) and its FLAGs (``NAME=VALUE`` becomes
``-DNAME=VALUE``; a FLAG that starts with ``-`` is passed as it is) into
``build/variants/``.  For each variant it prints ``ptxas``' registers and
spills and, from ``cuobjdump -sass``, each kernel's TF32 tensor-core
instructions (``HMMA.1688.F32.TF32``) and local-memory stores and loads
(``STL``/``LDL``, spills).  Every variant then runs, through the port's
wrapper, the cases of ``repro_torch.kernels.cases`` its kernel serves:
a forward every fp32 case of FLASH_CASES, RAGGED_CASES and BACKWARD_CASES
at ``tolerance("float32")``, a backward every BACKWARD_CASES case at
BACKWARD_LIMIT and twice with the same bits (the checkout's own kernel
supplies the other direction).  Each is timed at BACKWARD_TRAIN_CASE and
BACKWARD_LONG_CASE with CUDA events, the variants of a kind in turns (each
twice, in order and then reversed).

``--mma-rate`` also times a kernel of independent ``mma.sync`` m16n8k8
TF32 products (eight accumulators a warp) at 1, 2 and 4 blocks of 128
threads an SM: the rate this card gives that instruction.

All variants run in one process on one card, so their times compare.
Without a CUDA card it exits nonzero.
"""
from __future__ import annotations

import ctypes
import sys

import torch

# variant_tools puts the repository's src/ on sys.path.
from variant_tools import (OUT, build_variants, card, compile_variant,
                           ptxas_summary, sass_summary, time_ms)
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels.cases import (
    BACKWARD_CASES,
    BACKWARD_LIMIT,
    BACKWARD_LONG_CASE,
    BACKWARD_TRAIN_CASE,
    FLASH_CASES,
    RAGGED_CASES,
    max_ratio,
    tolerance,
)
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
)

LIBRARY = {"fwd": "flash_attention", "bwd": "flash_attention_bwd"}

MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_rate(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t t = threadIdx.x;
  const uint32_t a[4] = {t, t + 1, t + 2, t + 3};
  uint32_t b[8][2];
  for (int n = 0; n < 8; ++n) {
    b[n][0] = t * n;
    b[n][1] = n;
  }
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[n][0]),
            "r"(b[n][1]));
  float s = 0.f;
  for (int n = 0; n < 8; ++n) s += d[n][0] + d[n][1] + d[n][2] + d[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int odin_mma_rate(float* out, int blocks, int iters) {
  mma_rate<<<blocks, 128>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "mma_rate.cu"
    src.write_text(MMA_RATE_SOURCE)
    path, _ = compile_variant("mma_rate", src, [])
    fn = ctypes.CDLL(str(path)).odin_mma_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(4 * sms * 128, device="cuda")
    for per_sm in (1, 2, 4):
        blocks, iters = per_sm * sms, 4096
        ms = time_ms(lambda: fn(out.data_ptr(), blocks, iters), reps=5)
        flops = blocks * 4 * iters * 8 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 TF32, {per_sm} block(s) of 128 threads an "
              f"SM: {flops / ms / 1e9:.1f} TFLOP/s", flush=True)


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--mma-rate"]
    if not torch.cuda.is_available() or not (args or "--mma-rate" in
                                             sys.argv):
        print(__doc__)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    if "--mma-rate" in sys.argv:
        mma_rate()
    if not args:
        return 0
    libs = {}
    for name, (path, log) in build_variants(args).items():
        lib = ctypes.CDLL(str(path))
        kind = "fwd" if hasattr(lib, "odin_flash_attention_fwd_lse") else "bwd"
        print(f"{name} ({kind}): ptxas", flush=True)
        for line in ptxas_summary(log) + sass_summary(
                path, ("HMMA.1688.F32.TF32", "STL", "LDL")):
            print(f"  {line}", flush=True)
        libs[name] = (kind, lib)

    def use(name: str) -> None:
        # The wrapper loads its libraries through build.load, which returns
        # what build._LIBS holds for the name.
        kind, lib = libs[name]
        build._LIBS[LIBRARY[kind]] = lib

    def restore() -> None:
        for library in LIBRARY.values():
            build._LIBS.pop(library, None)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(case):
        B, Hq, Hkv, S, D = case[:5]
        return [torch.randn(s, generator=gen, device="cuda") for s in (
            (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D))]

    ok = True
    fwd_cases = [c for c in FLASH_CASES + RAGGED_CASES
                 if c[-1] == "float32"] + BACKWARD_CASES
    for case in dict.fromkeys(fwd_cases):
        causal, window = case[5], case[6]
        q, k, v, do = inputs(case)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        want = (flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                        window=window)
                if case in BACKWARD_CASES else None)
        readings = []
        for name, (kind, _) in libs.items():
            restore()
            if kind == "fwd":
                use(name)
                o, _ = k1.forward_with_lse(q, k, v, causal=causal,
                                           window=window)
                err, tol = o - ref, tolerance("float32")
                good = bool((err.abs() <= tol["atol"]
                             + tol["rtol"] * ref.abs()).all())
                readings.append(f"{name} {'ok' if good else 'BAD'} "
                                f"{float(err.abs().max()):.2e}")
            elif want is not None:
                o, lse = k1.forward_with_lse(q, k, v, causal=causal,
                                             window=window)
                use(name)
                got = k1.backward(q, k, v, o, lse, do, causal=causal,
                                  window=window)
                again = k1.backward(q, k, v, o, lse, do, causal=causal,
                                    window=window)
                ratio = max(max_ratio(g, w) for g, w in zip(got, want))
                good = (ratio <= BACKWARD_LIMIT
                        and all(torch.equal(a, b) for a, b in zip(got, again)))
                readings.append(f"{name} {'ok' if good else 'BAD'} "
                                f"{ratio:.2e}")
            else:
                continue
            ok &= good
        print(f"{case[:7]}: {', '.join(readings)}", flush=True)

    for case in (BACKWARD_TRAIN_CASE, BACKWARD_LONG_CASE):
        causal, window = case[5], case[6]
        q, k, v, do = inputs(case)
        restore()
        o, lse = k1.forward_with_lse(q, k, v, causal=causal, window=window)
        for kind in ("fwd", "bwd"):
            names = [n for n, (kd, _) in libs.items() if kd == kind]
            times = {n: [] for n in names}
            for name in names + names[::-1]:
                restore()
                use(name)
                times[name].append(time_ms(
                    (lambda: k1.forward_with_lse(q, k, v, causal=causal,
                                                 window=window))
                    if kind == "fwd" else
                    (lambda: k1.backward(q, k, v, o, lse, do, causal=causal,
                                         window=window))))
            if names:
                print(f"{case[:5]} {kind}: " + "  ".join(
                    f"{n} {t[0]:.4f}/{t[1]:.4f} ms" for n, t in times.items()),
                    flush=True)
    restore()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
