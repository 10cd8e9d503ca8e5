"""What the tools that compare kernel variants on one card share
(``k1_variants.py``, ``k1_fp32_variants.py``, ``k1_bf16_bwd_variants.py``,
``k23_variants.py``): building each ``NAME:SOURCE[:FLAG...]`` variant with
the port's ``nvcc`` flags, summarising ``ptxas``' log and the SASS, and
timing a call with CUDA events or ``torch.profiler``.  The tools import it
from their own directory, which Python puts first on ``sys.path`` when it
runs a script.
"""
from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "variants"
SPIN_CYCLES = 1_000_000       # about 0.5 ms: the host enqueue is not timed


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def compile_variant(name: str, source: Path, flags: list) -> tuple:
    """(library path, nvcc output) of ``source`` built into ``OUT`` with
    the port's flags, ``-I`` the kernels' ``csrc/`` and ``flags``
    (``NAME=VALUE`` becomes ``-DNAME=VALUE``; one that starts with ``-``
    is passed as it is); raises if nvcc fails."""
    OUT.mkdir(parents=True, exist_ok=True)
    out = OUT / f"lib{name}.so"
    opts = [f if f.startswith("-") else f"-D{f}" for f in flags]
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
                        *opts, "-o", str(out), str(source)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {name} failed:\n{r.stdout}{r.stderr}")
    return out, r.stdout + r.stderr


def build_variants(args: list) -> dict:
    """name -> (library path, nvcc output) for each ``NAME:SOURCE[:FLAG...]``
    of ``args`` (SOURCE a path relative to the repository's root), the
    variants compiled together."""
    specs = {}
    for arg in args:
        name, source, *flags = arg.split(":")
        specs[name] = (ROOT / source, flags)
    with ThreadPoolExecutor(max_workers=max(len(specs), 1)) as pool:
        built = {name: pool.submit(compile_variant, name, *spec)
                 for name, spec in specs.items()}
        return {name: f.result() for name, f in built.items()}


def ptxas_summary(log: str) -> list:
    """One line per entry function of an ``-Xptxas=-v`` log (registers,
    spills, stack frame), then every warning ptxas gave, serialised
    ``wgmma`` among them (an info line, "Potential Performance Loss")."""
    lines, warnings = [], []
    for line in log.splitlines():
        if "warning" in line.lower() or "Performance Loss" in line:
            warnings.append(line.strip())
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            lines.append([m.group(1)[-40:]])
        for key in ("Used \\d+ registers", "\\d+ bytes spill stores",
                    "\\d+ bytes spill loads", "\\d+ bytes stack frame"):
            found = re.search(key, line)
            if found and lines:
                lines[-1].append(found.group())
    return [" ".join(str(x) for x in entry) for entry in lines] + warnings


def sass_summary(lib: Path, opcodes: tuple, registers: bool = False) -> list:
    """One line per kernel of a library from ``cuobjdump -sass``: its
    highest register (with ``registers``), then how often each of
    ``opcodes`` occurs in it."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    lines = []
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        counts = [f"{op} {part.count(op)}" for op in opcodes]
        if registers:
            regs = [int(x) for x in re.findall(r"\bR(\d+)\b", part)]
            counts.insert(0, f"highest register R{max(regs, default=0)}")
        lines.append(f"{part.split()[0][-60:]}: {', '.join(counts)}")
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


def kernel_times(fn, reps: int = 20) -> str:
    """Device time per call of each CUDA kernel that ``fn`` launches, and
    its launches per call, from ``torch.profiler`` (over ``reps`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t > 0 and ev.count >= reps:
            rows.append(f"{ev.key[:60]} {t / reps / 1e3:.4f} ms "
                        f"x{ev.count // reps}")
    return "; ".join(rows) or "no device time recorded"
