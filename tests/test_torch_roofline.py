"""The port's Hopper roofline (``repro_torch.launch.roofline``) and
collective profiler (``repro_torch.launch.coll_profile``): the terms and
bottleneck of ``tests/test_roofline.py`` with the H100's constants, a
record of executed collectives in place of the HLO parser, the per-layer
cost model equal to the JAX one, chip_smoke's bounds unchanged now that
they read their peaks from the roofline, and the SPMD pipeline's record
on 4 gloo ranks."""
import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.coll_profile import \
    layer_coll_costs as jax_layer_coll_costs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import cases  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.coll_profile import (  # noqa: E402
    layer_coll_costs,
    top_collectives,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_are_the_h100_data_sheet():
    assert rl.PEAK_BF16_FLOPS == 989e12
    assert rl.PEAK_TF32_FLOPS == 495e12
    assert rl.PEAK_FP32_FLOPS == 67e12
    assert rl.HBM_BW == 3.35e12
    assert rl.LINK_BW == 450e9
    assert rl.peak_flops("bfloat16") == rl.peak_flops(torch.bfloat16) \
        == 989e12
    assert rl.peak_flops("float32") == 67e12
    assert rl.peak_flops(torch.float32, tf32=True) == 495e12
    with pytest.raises(ValueError):
        rl.peak_flops("int8")


def test_flat_collectives():
    rec = rl.CollectiveRecord()
    rec.add("all-gather", "ag", 32 * 8 * 4)
    rec.add("all-reduce", "ar", 8 * 8 * 4)
    cb = rl.collective_bytes(rec)
    assert set(cb) == set(rl.COLLECTIVES)
    assert cb["all-gather"] == 32 * 8 * 4
    assert cb["all-reduce"] == 8 * 8 * 4
    assert rl.collective_bytes(None) == {k: 0 for k in rl.COLLECTIVES}
    with pytest.raises(ValueError):
        rec.add("broadcast", "x", 1)


def test_loop_aware_collectives():
    """A record counts executed calls: a 6-step loop's all-gather counts
    6x, as the JAX parser multiplies a while body by its trip count."""
    rec = rl.CollectiveRecord()
    for _ in range(6):
        rec.add("all-gather", "loop body", 32 * 8 * 4)
    assert rl.collective_bytes(rec)["all-gather"] == 6 * 32 * 8 * 4


def test_terms_bottleneck():
    t = rl.RooflineTerms(
        flops=989e12 * 256,          # exactly 1s of bf16 compute on 256 cards
        bytes_accessed=3.35e12,      # ~0.004s memory
        hlo_flops=0, hlo_bytes=0,
        coll_bytes=450e9 * 3,        # 3s of collectives
        coll_breakdown={}, chips=256, model_flops=989e12 * 128,
    ).finalize()
    assert t.t_compute == pytest.approx(1.0)
    assert t.bottleneck == "collective"
    assert t.useful_ratio == pytest.approx(0.5)


@pytest.mark.parametrize("dtype,tf32,peak", [
    ("bfloat16", False, 989e12), ("float32", False, 67e12),
    ("float32", True, 495e12)])
def test_terms_peak_follows_the_dtype(dtype, tf32, peak):
    t = rl.analyze(2 * peak, 2, dtype=dtype, tf32=tf32,
                   counted_bytes=3.35e12 / 2).finalize()
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(0.25)
    assert t.bottleneck == "compute"
    assert t.hlo_flops == 2 * peak and t.coll_bytes == 0.0


def test_analyze_prefers_the_analytic_totals():
    t = rl.analyze(1e12, 1, counted_bytes=1e9,
                   analytic={"flops": 2e12, "bytes": 3.35e13})
    assert t.flops == 2e12 and t.hlo_flops == 1e12
    assert t.bytes_accessed == 3.35e13 and t.hlo_bytes == 1e9
    assert t.bottleneck == "memory"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layer_coll_costs_equal_jax(arch):
    for kw in ({}, dict(batch=4, seq=1024, bandwidth=4.5e11,
                        dtype_bytes=2)):
        got = layer_coll_costs(get_config(arch), **kw)
        want = jax_layer_coll_costs(jax_config(arch), **kw)
        np.testing.assert_array_equal(got, want)


def test_layer_coll_costs_from_a_record():
    cfg = get_config("qwen3-4b")
    rec = rl.CollectiveRecord()
    rec.add("collective-permute", "stage hand-off", 6_000)
    rec.add("collective-permute", "stage hand-off", 6_000)
    rec.add("all-reduce", "output broadcast", 24_000)
    got = layer_coll_costs(cfg, bandwidth=1e9, record=rec)
    np.testing.assert_allclose(got, 36_000 / cfg.num_blocks / 1e9)
    rows = top_collectives(rec)
    assert [b for b, _ in rows] == [24_000.0, 12_000.0]
    assert rows[0][1].split() == ["all-reduce", "output", "broadcast"]
    # An empty record leaves the analytic estimate.
    np.testing.assert_array_equal(
        layer_coll_costs(cfg, record=rl.CollectiveRecord()),
        layer_coll_costs(cfg))


def _old_bound(flops, nbytes, peak):
    """chip_smoke's bound before it read the roofline's constants."""
    t_ops, t_bytes = flops / peak, nbytes / 3.35e12
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def test_chip_smoke_bounds_are_unchanged():
    """Every bound chip_smoke prints for the kernel table's shapes, bit
    for bit, against the literal peaks it held before."""
    cs = _chip_smoke()
    assert (cs.PEAK_BF16_FLOPS, cs.PEAK_FP32_FLOPS, cs.PEAK_TF32_FLOPS,
            cs.HBM_BW) == (989e12, 67e12, 495e12, 3.35e12)
    work = []
    for c in (cases.MAIN_CASES + cases.BATCHED_MAIN_CASES
              + cases.FAMILY_MAIN_CASES):
        B, Hq, Hkv, S, D, causal, window, dtype = c
        pairs = cs.attention_pairs(S, causal, window)
        work.append((2 * 2 * B * Hq * pairs * D,
                     (2 * Hq + 2 * Hkv) * B * S * D * 2, 989e12))
        assert cs.attention_bound(B, Hq, Hkv, S, D, causal, 2, window) \
            == _old_bound(*work[-1])
    for c in (cases.BACKWARD_TRAIN_CASE, cases.BACKWARD_LONG_CASE):
        for fn in (cs.fwd_work, cs.bwd_work):
            needed, _, nbytes = fn(*c[:7])
            work += [(needed, nbytes, 67e12), (3 * needed, nbytes, 495e12)]
            assert cs.fp32_bounds(needed, nbytes)[1:] == (
                _old_bound(needed, nbytes, 67e12),
                _old_bound(3 * needed, nbytes, 495e12))
        for fn in (cs.bf16_fwd_work, cs.bf16_bwd_work):
            needed, _, nbytes = fn(*c[:7])
            work.append((needed, nbytes, 989e12))
    b, S, H, P, N, chunk, _ = cases.SSD_MAIN_CASE
    work.append((*cs.ssd_work(b, S, H, P, N, chunk, 2), 989e12))
    B, Hq, Hkv, S, D, index, window, _ = cases.DECODE_MAIN_CASE
    work.append((*cs.decode_work(B, Hq, Hkv, S, D, index, window, 2),
                 989e12))
    for flops, nbytes, peak in work:
        assert cs.bound(flops, nbytes, peak) == _old_bound(flops, nbytes,
                                                           peak)
    # The kernel table's first K1, K2 and K3 bounds (PERF.md).
    assert round(cs.attention_bound(1, 32, 8, 1024, 128, True, 2)[0], 5) \
        == 0.00869
    assert round(cs.bound(*work[-1])[0], 5) == 0.00128
    assert round(cs.bound(*work[-2])[0], 5) == 0.00299


# Run as a file by one subprocess (no JAX in the ranks): 4 gloo ranks run
# the GPipe schedule once and report their collective records.
RANKS_SCRIPT = '''
import dataclasses, json, sys
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_stage_mesh, spawn_ranks
from repro_torch.launch.roofline import collective_bytes
from repro_torch.models.model import Model
from repro_torch.pipeline.spmd import make_pipeline_fn, stage_tile

M, MB, S, CAP, CONFIG = {m}, {mb}, {s}, {cap}, {config}


def rank_main(rank):
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), num_layers=8)
    params = Model(cfg).init_params(seed=0, device="cpu")
    mesh = make_stage_mesh(4, device="cpu")
    fn = make_pipeline_fn(cfg, mesh, num_microbatches=M, cap=CAP)
    tile = stage_tile(params["blocks"], CONFIG, CAP,
                      mesh.axis_index("stage"))
    inputs = torch.randn((M, MB, S, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    fn(tile, CONFIG, inputs)
    return dict(stage=mesh.axis_index("stage"), sends=fn.sends,
                d_model=cfg.d_model,
                by_kind=collective_bytes(fn.collectives),
                rows=sorted((k, o, b) for (k, o), b
                            in fn.collectives.rows.items()))


if __name__ == "__main__":
    print(json.dumps(spawn_ranks(rank_main, 4, backend="gloo",
                                 init_file=sys.argv[1])))
'''


def test_spmd_record_counts_the_schedule(tmp_path):
    """Each rank's ``collective-permute`` bytes are its hand-offs: M
    microbatch tiles ([mb, S, d] fp32) on stages 0-2, none on the last
    stage; the outputs' broadcast ([M, mb, S, d]) is one ``all-reduce`` on
    every rank.

    JAX's ``collective_bytes`` of the same compiled pipeline (the JAX
    ``pipeline/spmd.py``: a ``fori_loop`` of n + M - 1 steps with a
    ``ppermute`` of one tile each step, then a masked ``psum`` of the
    outputs) counts (n + M - 1) tiles of ``collective-permute`` on every
    chip, the steps where a stage is idle and the last stage's included,
    and the same outputs buffer as ``all-reduce``.  So on stages 0 to n-2
    the port's hand-offs are M / (n + M - 1) of JAX's count (4 of 7
    here), on the last stage 0 of 7, and the all-reduce bytes are equal.
    """
    M, MB, S, CAP, CONFIG = 4, 2, 16, 4, [2, 2, 2, 2]
    script = tmp_path / "ranks.py"
    script.write_text(RANKS_SCRIPT.format(m=M, mb=MB, s=S, cap=CAP,
                                          config=CONFIG))
    env = {"PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", str(tmp_path))}
    r = subprocess.run([sys.executable, str(script),
                        str(tmp_path / "rendezvous")],
                       capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = json.loads(r.stdout.strip().splitlines()[-1])
    assert [o["stage"] for o in ranks] == [0, 1, 2, 3]
    tile = MB * S * ranks[0]["d_model"] * 4
    for o in ranks:
        last = o["stage"] == 3
        want = {k: 0 for k in rl.COLLECTIVES}
        want["collective-permute"] = 0 if last else M * tile
        want["all-reduce"] = M * tile
        assert o["by_kind"] == want, o
        assert o["sends"] == (0 if last else M)
        rows = {(k, op): b for k, op, b in o["rows"]}
        assert rows[("all-reduce", "output broadcast")] == M * tile
        assert rows.get(("collective-permute", "stage hand-off"), 0) == \
            o["sends"] * tile
    n = len(CONFIG)
    jax_permute = (n + M - 1) * tile
    assert ranks[0]["by_kind"]["collective-permute"] * (n + M - 1) == \
        jax_permute * M


def test_dataclass_fields_keep_the_jax_names():
    from repro.launch.roofline import RooflineTerms as JaxTerms
    jax_fields = [f.name for f in dataclasses.fields(JaxTerms)]
    port_fields = [f.name for f in dataclasses.fields(rl.RooflineTerms)]
    assert set(jax_fields) <= set(port_fields)
    assert set(port_fields) - set(jax_fields) == {"dtype", "tf32"}
