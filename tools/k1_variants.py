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
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    FLASH_CASES,
    MAIN_CASES,
    MAIN_RMS_LIMIT,
    MAIN_TOLERANCE,
    RAGGED_CASES,
    TENSOR_CORE_CASES,
    tolerance,
)
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

OUT = ROOT / "build" / "variants"
SPIN_CYCLES = 1_000_000       # about 0.5 ms: the host enqueue is not timed


def compile_variant(name: str, source: Path, flags: list) -> tuple:
    """(library path, nvcc output); raises if nvcc fails."""
    out = OUT / f"lib{name}.so"
    opts = [f if f.startswith("-") else f"-D{f}" for f in flags]
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *opts, "-o",
                        str(out), str(source)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {name} failed:\n{r.stdout}{r.stderr}")
    return out, r.stdout + r.stderr


def sass_summary(lib: Path) -> list:
    """One line per kernel of a library: highest register, STL, LDL,
    HGMMA and WARPGROUP.DEPBAR counts."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    lines = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        regs = [int(x) for x in re.findall(r"\bR(\d+)\b", part)]
        lines.append(f"{part.split()[0]}: highest register R{max(regs)}, "
                     f"STL {part.count('STL')}, LDL {part.count('LDL')}, "
                     f"HGMMA {part.count('HGMMA')}, WARPGROUP.DEPBAR "
                     f"{part.count('WARPGROUP.DEPBAR')}")
    return lines


def time_ms(fn, reps: int = 30, flush=None) -> float:
    """Median CUDA-event time of ``fn`` after warm-up; ``flush()`` runs
    before each timed call, outside the timing."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    specs = {}
    for arg in sys.argv[1:]:
        name, source, *flags = arg.split(":")
        specs[name] = (ROOT / source, flags)
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        built = {name: pool.submit(compile_variant, name, *spec)
                 for name, spec in specs.items()}
        built = {name: f.result() for name, f in built.items()}
    libs = {}
    for name, (path, log) in built.items():
        ptxas = re.findall(r"(\d+ bytes spill stores, \d+ bytes spill loads"
                           r"|Used \d+ registers)", log)
        print(f"{name}: ptxas {ptxas}", flush=True)
        for line in sass_summary(path):
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
