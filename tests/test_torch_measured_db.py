"""The port's measured interference database (``repro_torch.launch.
measured_db`` and ``stressors``) against the JAX package's
``tools/build_measured_db.py``, on the CPU at smoke width: the copied
scenarios and stressors, a measured table, the saved JSON read by both
packages' ``LayerDatabase.load``, and the faults that must raise."""
import dataclasses
import importlib.util
import inspect
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import LayerDatabase as JaxLayerDatabase  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import LayerDatabase  # noqa: E402
from repro_torch.launch import measured_db, stressors  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.pipeline import LocalPipelineExecutor  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCENARIOS = ("none", "ibench-cpu-1t", "ibench-membw-1t")


@pytest.fixture(scope="module")
def tool():
    """The JAX tool, loaded by path (it imports only numpy at its top;
    its dataclass needs the module in ``sys.modules`` while it loads)."""
    name = "_jax_build_measured_db"
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / "build_measured_db.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        del sys.modules[name]


@pytest.fixture(scope="module")
def smoke():
    """Smoke-width qwen3-4b cut to 2 blocks on the CPU, tokens of 16."""
    cfg = get_smoke_config("qwen3-4b")
    cfg = dataclasses.replace(cfg, num_layers=2 * len(cfg.layer_pattern))
    params = Model(cfg).init_params(0, torch.float32, "cpu")
    ex = LocalPipelineExecutor(cfg, params, "cpu")
    ex.warmup(1, 16)
    return cfg, ex, torch.zeros((1, 16), dtype=torch.long)


@pytest.fixture(scope="module")
def measured(smoke):
    cfg, ex, tokens = smoke
    by_name = {sc.name: sc for sc in stressors.scenarios_table1()}
    return measured_db.measure(ex, tokens, [by_name[n] for n in SCENARIOS],
                               repeats=1, log=lambda _: None)


def test_scenarios_equal_the_tools(tool):
    got = [(s.name, s.kind, s.procs) for s in stressors.scenarios_table1()]
    want = [(s.name, s.kind, s.procs) for s in tool.scenarios_table1()]
    assert got == want and len(got) == 11
    assert [f.name for f in dataclasses.fields(stressors.Scenario)] == \
        [f.name for f in dataclasses.fields(tool.Scenario)]


@pytest.mark.parametrize("name", ["_cpu_stressor", "_membw_stressor"])
def test_stressor_bodies_equal_the_tools(tool, name):
    assert inspect.getsource(getattr(stressors, name)) == \
        inspect.getsource(getattr(tool, name))


def test_card_rows():
    rows = stressors.card_scenarios()
    assert [(s.name, s.kind, s.procs) for s in rows] == [
        ("card-matmul-1p", "card-matmul", 1),
        ("card-matmul-2p", "card-matmul", 2),
        ("card-hbm-1p", "card-hbm", 1), ("card-hbm-2p", "card-hbm", 2)]
    assert all(s.kind in stressors.TARGETS for s in rows)


def test_measure_gives_a_positive_table(measured):
    assert measured.table.shape == measured.medians.shape == (2, 3)
    assert measured.names == list(SCENARIOS)
    assert np.all(np.isfinite(measured.table)) and np.all(measured.table > 0)
    # One repeat: the minimum is the median.
    np.testing.assert_array_equal(measured.table, measured.medians)
    assert [len(measured.load[n]["startup_s"]) for n in SCENARIOS] == \
        [0, 1, 1]


def test_saved_database_loads_in_both_packages(measured, smoke, tmp_path):
    cfg = smoke[0]
    out = str(tmp_path / "db" / "measured_db.json")
    meta = measured_db.run_meta(torch.device("cpu"), measured)
    measured_db.save(measured_db.database(measured, cfg), meta, out)
    for db in (LayerDatabase.load(out), JaxLayerDatabase.load(out)):
        np.testing.assert_array_equal(db.table, measured.table)
        assert list(db.scenario_names) == list(SCENARIOS)
        assert list(db.unit_names) == ["block0", "block1"]
        assert db.model_name == f"{cfg.name}-measured"
    with open(out) as f:
        assert sorted(json.load(f)) == ["model_name", "scenario_names",
                                        "table", "unit_names"]
    with open(tmp_path / "db" / "measured_db.meta.json") as f:
        side = json.load(f)
    assert side["card"] is None and side["cpu_count"] >= 1
    assert side["median_s"]["none"] == measured.medians[:, 0].tolist()


def test_cli_prints_the_tools_lines(monkeypatch, tmp_path, capsys):
    """The CLI on the CPU, its scenarios cut to two so the test stays
    short: the reference's lines, the median beside each, the files."""
    monkeypatch.setattr(measured_db, "scenarios_table1",
                        lambda: stressors.scenarios_table1()[:2])
    out = str(tmp_path / "m.json")
    measured_db.main(["--device", "cpu", "--blocks", "2", "--seq", "16",
                      "--repeats", "2", "--out", out])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("measuring qwen3-4b (2 blocks) under Table-1 "
                        "stressor scenarios...")
    assert lines[1].startswith("  none               mean_block=")
    assert lines[2].startswith("      median of 2: mean_block=")
    assert lines[3].startswith("  ibench-cpu-1t      mean_block=")
    assert lines[-2] == f"saved 2x2 database -> {out}"
    assert lines[-1].startswith("impact range: x")
    assert JaxLayerDatabase.load(out).table.shape == (2, 2)


def test_card_tenants_on_the_cpu_raise():
    with pytest.raises(ValueError, match="CUDA"):
        measured_db.main(["--card-tenants", "--device", "cpu", "--blocks",
                          "2", "--seq", "16", "--repeats", "1"])


def test_card_tenants_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measured_db.main(["--card-tenants", "--blocks", "2", "--seq", "16",
                          "--repeats", "1"])


def test_a_stressor_that_exits_at_once_raises(smoke, monkeypatch):
    """A child whose target returns at once never signals readiness:
    ``measure`` raises instead of timing without the load."""
    cfg, ex, tokens = smoke
    monkeypatch.setitem(stressors.TARGETS, "cpu", id)
    rows = stressors.scenarios_table1()[:2]
    with pytest.raises(RuntimeError, match="exited with code 0"):
        measured_db.measure(ex, tokens, rows, repeats=1, log=lambda _: None)
