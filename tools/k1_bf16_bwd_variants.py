"""Compile variants of K1's bf16 backward and compare them on one card.

    python3 tools/k1_bf16_bwd_variants.py NAME:SOURCE[:FLAG...] ...

Each variant is a CUDA source with the C interface of
``src/repro_torch/kernels/csrc/flash_attention_bwd_bf16.cu``, a path
relative to the repository's root, compiled by ``nvcc`` with the port's
flags (``repro_torch.kernels.build.NVCC_FLAGS``), ``-I`` the kernels'
``csrc/`` (for ``hopper_bf16.cuh``) and its FLAGs (``NAME=VALUE`` becomes
``-DNAME=VALUE``; a FLAG that starts with ``-`` is passed as it is) into
``build/variants/``.  For each variant it prints ``ptxas``' lines for each
kernel (registers, spills, and any warning that it serialised the
``wgmma``s) and, from ``cuobjdump -sass``, each kernel's ``HGMMA``
(``wgmma``), ``HMMA`` (``mma.sync``) and local-memory (``STL``/``LDL``)
instructions.  Every variant then runs, through the port's wrapper, every
case of BACKWARD_BF16_CASES, held to BACKWARD_BF16_LIMIT,
BACKWARD_BF16_RMS_LIMIT and BACKWARD_BF16_ZERO_ATOL against the plain
backward, two calls giving the same bits.  Each variant is timed at the
three timed shapes of cases.py (BACKWARD_BF16_TRAIN_CASE, _LONG_CASE,
_WIDE_CASE) with CUDA events, in turns (in order and then reversed),
beside autograd's backward of bf16 ``scaled_dot_product_attention`` and
K1's bf16 forward entry points (the forward's plain and LSE entries of the
checkout), and its launches' device times are read by ``torch.profiler``.

All variants run in one process on one card, so their times compare.
Without a CUDA card it exits nonzero.
"""
from __future__ import annotations

import ctypes
import sys

import torch

# variant_tools puts the repository's src/ on sys.path.
from variant_tools import (build_variants, card, kernel_times,
                           ptxas_summary, sass_summary, time_ms)
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as k1
from repro_torch.kernels.cases import (
    BACKWARD_BF16_CASES,
    BACKWARD_BF16_LONG_CASE,
    BACKWARD_BF16_TRAIN_CASE,
    BACKWARD_BF16_WIDE_CASE,
    bf16_backward_check,
)
from repro_torch.kernels.ref import flash_attention_bwd_ref

LIBRARY = "flash_attention_bwd_bf16"
TIMED = (BACKWARD_BF16_TRAIN_CASE, BACKWARD_BF16_LONG_CASE,
         BACKWARD_BF16_WIDE_CASE)


def main() -> int:
    args = sys.argv[1:]
    if not torch.cuda.is_available() or not args:
        print(__doc__)
        return 2
    print(card(), flush=True)
    libs = {}
    for name, (path, log) in build_variants(args).items():
        print(f"{name}: ptxas", flush=True)
        for line in ptxas_summary(log) + sass_summary(
                path, ("HGMMA", "HMMA", "STL", "LDL")):
            print(f"  {line}", flush=True)
        libs[name] = ctypes.CDLL(str(path))

    def use(name: str) -> None:
        # The wrapper loads its library through build.load, which returns
        # what build._LIBS holds for the name.
        build._LIBS[LIBRARY] = libs[name]

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(case):
        B, Hq, Hkv, S, D = case[:5]
        return [torch.randn(s, generator=gen, device="cuda").bfloat16()
                for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                          (B, Hq, S, D))]

    ok = True
    for case in BACKWARD_BF16_CASES:
        causal, window = case[5], case[6]
        q, k, v, do = inputs(case)
        _, lse, o32 = k1.forward_for_backward(q, k, v, causal=causal,
                                              window=window)
        want = flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                       window=window)
        readings = []
        for name in libs:
            use(name)
            got = k1.backward(q, k, v, o32, lse, do, causal=causal,
                              window=window)
            again = k1.backward(q, k, v, o32, lse, do, causal=causal,
                                window=window)
            torch.cuda.synchronize()
            checks = [bf16_backward_check(g, w) for g, w in zip(got, want)]
            repeat = all(torch.equal(a, b) for a, b in zip(got, again))
            good = all(c[2] for c in checks) and repeat
            ok &= good
            readings.append(
                f"{name} {'ok' if good else 'BAD'} " + " ".join(
                    f"{c[0]:.2e},{c[1]:.2e}" for c in checks)
                + ("" if repeat else " two calls differ"))
        print(f"{case[:7]}: " + "; ".join(readings), flush=True)

    for case in TIMED:
        causal, window = case[5], case[6]
        q, k, v, do = inputs(case)
        _, lse, o32 = k1.forward_for_backward(q, k, v, causal=causal,
                                              window=window)

        def call():
            return k1.backward(q, k, v, o32, lse, do, causal=causal,
                               window=window)
        times = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            use(name)
            times[name].append(time_ms(call))
        lq, lk, lv = (t.clone().requires_grad_(True) for t in (q, k, v))
        lo = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=causal, enable_gqa=True)
        sdpa = time_ms(lambda: torch.autograd.grad(
            lo, (lq, lk, lv), do, retain_graph=True))
        fwd = time_ms(lambda: k1.forward_for_backward(
            q, k, v, causal=causal, window=window))
        plain = time_ms(lambda: k1.flash_attention(
            q, k, v, causal=causal, window=window))
        print(f"{case[:5]}: " + "  ".join(
            f"{n} {t[0]:.4f}/{t[1]:.4f}" for n, t in times.items())
            + f"  sdpa backward {sdpa:.4f}  forward LSE entry {fwd:.4f}, "
            f"plain entry {plain:.4f} ms", flush=True)
        for name in libs:
            use(name)
            print(f"  {name} device time a call by kernel: "
                  + kernel_times(call), flush=True)
    build._LIBS.pop(LIBRARY, None)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
