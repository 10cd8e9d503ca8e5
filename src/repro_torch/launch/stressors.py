"""Co-located load for the measured interference database (paper §3.3).

``Scenario``, ``scenarios_table1``, ``_cpu_stressor`` and
``_membw_stressor`` are copies of the JAX package's
``tools/build_measured_db.py``; ``tests/test_torch_measured_db.py`` holds
them equal to the originals.  The card co-tenants (``card_scenarios``) are
the port's own: the Table-1 rows load the host, and these load the card
that holds the model's memory and does its compute.

Every stressor runs in a child started with the ``spawn`` method (the
parent holds a CUDA context, and ``fork`` after CUDA is initialised is
unsafe).  A spawned child imports the module of its target, so this one
imports only numpy at its top level; the card co-tenants import torch
inside their bodies.  ``Stressors`` also starts each child without the
parent's ``__main__`` module, which spawn would otherwise run again in
every child (for ``chip_smoke.py`` or the measured_db CLI, torch and the
whole port).

Each child polls its stop flag once an iteration through ``_Probe``, which
counts the polls and signals readiness at the second, after the first
iteration; ``Stressors`` waits for every signal, with a time limit, before
the caller times anything.  A child that dies, exits non-zero, misses its
readiness limit or does not stop raises ``RuntimeError``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import multiprocessing as mp
import sys
import time
import types
from typing import List, Optional

import numpy as np

READY_TIMEOUT_S = 60.0     # from start to every child's first iteration
STOP_TIMEOUT_S = 30.0      # from the stop flag to every child's exit
POLL_S = 0.01

# -- copies of tools/build_measured_db.py --------------------------------------


def _cpu_stressor(stop):
    x = 1.0001
    while not stop.value:
        for _ in range(10000):
            x = x * 1.0000001 + 1e-9
    return x


def _membw_stressor(stop):
    a = np.zeros(64 * 1024 * 1024 // 8)  # 64 MiB stream
    b = np.ones_like(a)
    while not stop.value:
        a += b                            # streaming read+write
    return a


@dataclasses.dataclass
class Scenario:
    name: str
    kind: str      # "cpu" | "membw"
    procs: int


def scenarios_table1():
    out = [Scenario("none", "none", 0)]
    # Table-1 thread counts, capped at 16 (32 heavily oversubscribes a
    # host's cores and just measures the scheduler)
    for n in (1, 2, 4, 8, 16):
        out.append(Scenario(f"ibench-cpu-{n}t", "cpu", n))
    for n in (1, 2, 4, 8, 16):
        out.append(Scenario(f"ibench-membw-{n}t", "membw", n))
    return out


# -- card co-tenants -------------------------------------------------------------

MATMUL_N = 8192            # bf16 operands of torch.mm
HBM_COPY_BYTES = 2 << 30   # each of the two buffers: about 40x the 50 MiB L2


def _card_matmul(stop, device_index):
    """bf16 ``torch.mm`` of MATMUL_N x MATMUL_N operands in a loop, one
    product a poll (cuBLAS: this process is load, not a kernel of the
    port)."""
    import torch

    dev = torch.device("cuda", device_index)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(MATMUL_N, MATMUL_N, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    b = torch.randn(MATMUL_N, MATMUL_N, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    c = torch.empty_like(a)
    while not stop.value:
        torch.mm(a, b, out=c)
        torch.cuda.synchronize(dev)
    return c


def _card_hbm(stop, device_index):
    """``dst.copy_(src)`` between two HBM_COPY_BYTES buffers in a loop, one
    copy a poll: the traffic goes to HBM, not the L2."""
    import torch

    dev = torch.device("cuda", device_index)
    src = torch.ones(HBM_COPY_BYTES, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    while not stop.value:
        dst.copy_(src)
        torch.cuda.synchronize(dev)
    return dst


def card_scenarios() -> List[Scenario]:
    """The rows ``--card-tenants`` appends: co-tenants on the model's card,
    one and two processes of each kind."""
    return [Scenario(f"card-{kind}-{n}p", f"card-{kind}", n)
            for kind in ("matmul", "hbm") for n in (1, 2)]


TARGETS = {"cpu": _cpu_stressor, "membw": _membw_stressor,
           "card-matmul": _card_matmul, "card-hbm": _card_hbm}


def is_card(scenario: Scenario) -> bool:
    return scenario.kind.startswith("card-")


# -- running one scenario's stressors -------------------------------------------


class _Probe:
    """Stands in for the stop flag a stressor polls once an iteration: it
    counts the polls into ``iters`` and signals readiness at the second,
    which comes after the first iteration."""

    def __init__(self, stop, ready, iters, ready_at):
        self._stop, self._ready = stop, ready
        self._iters, self._ready_at = iters, ready_at
        self._polls = 0

    @property
    def value(self):
        self._polls += 1
        self._iters.value = self._polls - 1
        if self._polls == 2:
            self._ready_at.value = time.time()
            with self._ready.get_lock():
                self._ready.value += 1
        return self._stop.value


def _child(target, args, stop, ready, iters, ready_at):
    target(_Probe(stop, ready, iters, ready_at), *args)


@contextlib.contextmanager
def _without_main():
    """Hide ``__main__`` while a child starts, so spawn does not run the
    parent's main module again in it (the child then imports only
    ``multiprocessing``, this module and numpy)."""
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = main


class Stressors:
    """The processes of one scenario, running between ``__enter__`` and
    ``__exit__``.

    ``__enter__`` starts ``scenario.procs`` children and returns once each
    has done its first iteration; ``startup_s`` holds each child's time
    from its start to that point.  ``iterations()`` reads the children's
    iteration counts, ``check_alive()`` raises if one has ended.
    ``__exit__`` sets the stop flag and joins every child, and raises if
    one exited non-zero or did not stop.
    """

    def __init__(self, scenario: Scenario,
                 device_index: Optional[int] = None):
        self.scenario = scenario
        # A card co-tenant runs on CUDA device ``device_index`` (None: the
        # child's current device).
        self._args = (device_index,) if is_card(scenario) else ()
        self._procs: list = []
        self._iters: list = []
        self.startup_s: List[float] = []

    def __enter__(self) -> "Stressors":
        sc = self.scenario
        if sc.procs == 0:
            return self
        ctx = mp.get_context("spawn")
        self._stop = ctx.Value(ctypes.c_int, 0)
        self._ready = ctx.Value(ctypes.c_int, 0)
        self._iters = [ctx.RawValue(ctypes.c_long, 0) for _ in range(sc.procs)]
        self._ready_at = [ctx.RawValue(ctypes.c_double, 0.0)
                          for _ in range(sc.procs)]
        target = TARGETS[sc.kind]
        t0 = time.time()
        try:
            with _without_main():
                for i in range(sc.procs):
                    p = ctx.Process(
                        target=_child, daemon=True,
                        name=f"{sc.name}-{i}",
                        args=(target, self._args, self._stop, self._ready,
                              self._iters[i], self._ready_at[i]))
                    p.start()
                    self._procs.append(p)
            self._wait_ready()
        except BaseException:
            self._shut_down()
            raise
        self.startup_s = [r.value - t0 for r in self._ready_at]
        return self

    def _wait_ready(self) -> None:
        deadline = time.perf_counter() + READY_TIMEOUT_S
        while self._ready.value < len(self._procs):
            self.check_alive()
            if time.perf_counter() > deadline:
                raise RuntimeError(
                    f"{self.scenario.name}: {self._ready.value} of "
                    f"{len(self._procs)} stressors ready after "
                    f"{READY_TIMEOUT_S:.0f} s")
            time.sleep(POLL_S)

    def check_alive(self) -> None:
        dead = [p for p in self._procs if not p.is_alive()]
        if dead:
            raise RuntimeError(
                f"{self.scenario.name}: stressor "
                + ", ".join(f"{p.name} exited with code {p.exitcode}"
                            for p in dead)
                + " while it should have been running")

    def iterations(self) -> List[int]:
        return [v.value for v in self._iters]

    def _shut_down(self) -> List[str]:
        """Stop and join every child; what went wrong, if anything."""
        if not self._procs:
            return []
        self._stop.value = 1
        deadline = time.perf_counter() + STOP_TIMEOUT_S
        faults = []
        for p in self._procs:
            p.join(timeout=max(deadline - time.perf_counter(), 0.0))
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=5)
                faults.append(f"{p.name} did not stop within "
                              f"{STOP_TIMEOUT_S:.0f} s")
            elif p.exitcode != 0:
                faults.append(f"{p.name} exited with code {p.exitcode}")
        self._procs = []
        return faults

    def __exit__(self, exc_type, exc, tb) -> None:
        faults = self._shut_down()
        if faults and exc_type is None:
            raise RuntimeError(f"{self.scenario.name}: " + "; ".join(faults))
