"""The port stands alone: no module of ``repro_torch`` (nor the card's
check script) imports JAX or the JAX package, and asking for CUDA on a
machine without a card fails instead of running on the CPU."""
import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# A string that names a module of the JAX package, as a registry's
# ``builtins_module`` or ``importlib.import_module`` would take it.
MODULE_NAME = re.compile(r"^repro(\.\w+)+$")


def _env():
    return {"PYTHONPATH": str(ROOT / "src"),
            "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
            "HOME": os.environ.get("HOME", "/tmp")}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _module_name_strings(path: pathlib.Path):
    """String constants that name a module of the JAX package: the AST
    check above cannot see an import made by name at run time."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and MODULE_NAME.match(node.value)):
            yield node.value


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_neither_jax_nor_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
    names = sorted(set(_module_name_strings(path)))
    assert not names, f"{path.relative_to(ROOT)} names modules {names}"


def test_module_name_check_sees_strings(tmp_path):
    """The string check catches a registry's builtins module, and leaves
    docstrings that mention the JAX package alone."""
    src = tmp_path / "m.py"
    src.write_text('"""Mirrors repro.workloads."""\n'
                   'R = Registry("w", builtins_module='
                   '"repro.workloads.generators")\n'
                   'OK = "repro_torch.workloads.generators"\n')
    assert list(_module_name_strings(src)) == ["repro.workloads.generators"]


def test_import_leaves_jax_and_repro_unloaded():
    code = ("import sys, repro_torch, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.workloads, repro_torch.telemetry, "
            "repro_torch.pipeline.spmd, repro_torch.launch.mesh\n"
            "from repro_torch.workloads import make_lengths, make_workload\n"
            "make_workload('bursty', burst_rate=5.0, seed=0)"
            ".inter_arrivals(8)\n"
            "make_lengths('bimodal', short=4, long=16).sample(8)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\nprint('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=str(ROOT), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK" in r.stdout


def test_serve_cli_without_cpu_flag_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--queries", "2"],
        capture_output=True, text=True, env=_env(), cwd=str(ROOT),
        timeout=120)
    assert r.returncode != 0
    assert "cuda" in r.stderr.lower()


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, env=_env(),
                       cwd=str(ROOT), timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
