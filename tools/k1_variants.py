"""Compile variants of K1's bf16 kernel and compare them on one card.

    python3 tools/k1_variants.py NAME:SOURCE[:FLAG...] [NAME:SOURCE[:FLAG...] ...]

Each variant is a CUDA source with the C interface of
``src/repro_torch/kernels/csrc/flash_attention_bf16.cu`` (a path relative
to the repository's root), compiled by ``nvcc`` with the port's flags
(``repro_torch.kernels.build.NVCC_FLAGS``) plus its FLAGs (``NAME=VALUE``
becomes ``-DNAME=VALUE``; a FLAG that starts with ``-`` is passed as it
is) into ``build/variants/``.  For each variant it prints ``ptxas``'
registers and spills and, from ``cuobjdump -sass``, each kernel's highest
register, its local-memory stores and loads (``STL``/``LDL``, spills), its
``wgmma`` instructions (``HGMMA``) and the waits on them
(``WARPGROUP.DEPBAR``; one after every ``HGMMA`` means ``ptxas``
serialised them).  Then every variant runs the bf16 cases of
``repro_torch.kernels.cases`` at their limits, and K1's main shape (q
``[1, 32, S, 128]``, k/v ``[1, 8, S, 128]``, causal) is timed at S = 1024,
2048 and 4096 with CUDA events, the variants in turns (each twice, in
order and then reversed), beside ``scaled_dot_product_attention``.

All variants run in one process on one card, so their times compare.
Without a CUDA card it exits nonzero.
"""
from __future__ import annotations

import ctypes
import sys

import torch

# variant_tools puts the repository's src/ on sys.path.
from variant_tools import build_variants, card, ptxas_summary, sass_summary
from variant_tools import time_ms
from repro_torch.kernels import build, ops
from repro_torch.kernels.cases import (
    FLASH_CASES,
    MAIN_CASES,
    MAIN_RMS_LIMIT,
    MAIN_TOLERANCE,
    RAGGED_CASES,
    TENSOR_CORE_CASES,
    tolerance,
)
from repro_torch.kernels.ref import flash_attention_ref


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    libs = {}
    for name, (path, log) in build_variants(sys.argv[1:]).items():
        print(f"{name}: ptxas", flush=True)
        for line in ptxas_summary(log) + sass_summary(
                path, ("STL", "LDL", "HGMMA", "WARPGROUP.DEPBAR"),
                registers=True):
            print(f"  {line}", flush=True)
        libs[name] = ctypes.CDLL(str(path))

    def use(name: str) -> None:
        # The wrapper loads its library through build.load, which returns
        # what build._LIBS holds for the name.
        build._LIBS["flash_attention_bf16"] = libs[name]

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    ok = True
    cases = [(c, tolerance("bfloat16"), None) for c in
             FLASH_CASES + RAGGED_CASES + TENSOR_CORE_CASES
             if c[-1] == "bfloat16"]
    cases += [(c, MAIN_TOLERANCE, MAIN_RMS_LIMIT) for c in MAIN_CASES]
    for case, tol, rms_limit in cases:
        B, Hq, Hkv, S, D, causal, window, _ = case
        q, k, v = randn((B, Hq, S, D)), randn((B, Hkv, S, D)), randn(
            (B, Hkv, S, D))
        ref = flash_attention_ref(q, k, v, causal=causal,
                                  window=window).float()
        readings = []
        for name in libs:
            use(name)
            out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                      impl="cuda").float()
            d = out - ref
            ratio = float(d.square().mean().sqrt() / ref.square().mean().sqrt())
            good = (bool(torch.isfinite(out).all())
                    and bool((d.abs() <= tol["atol"]
                              + tol["rtol"] * ref.abs()).all())
                    and (rms_limit is None or ratio <= rms_limit))
            ok &= good
            readings.append(f"{name} {'ok' if good else 'BAD'} rms {ratio:.2e}")
        print(f"{case}: {', '.join(readings)}", flush=True)

    for S in (1024, 2048, 4096):
        q, k, v = randn((1, 32, S, 128)), randn((1, 8, S, 128)), randn(
            (1, 8, S, 128))
        flops = 4 * 32 * 128 * S * (S + 1) / 2
        times = {name: [] for name in libs}
        for name in list(libs) + list(reversed(list(libs))):
            use(name)
            times[name].append(time_ms(
                lambda: ops.flash_attention(q, k, v, impl="cuda")))
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        print(f"S={S}: " + "  ".join(
            f"{n} {t[0]:.4f}/{t[1]:.4f} ms ({flops / min(t) / 1e9:.1f} "
            f"TFLOP/s)" for n, t in times.items())
            + f"  scaled_dot_product_attention {sdpa:.4f} ms "
            f"({flops / sdpa / 1e9:.1f} TFLOP/s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
