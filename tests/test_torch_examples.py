"""The port's device examples on the CPU: each default config equals the
JAX example's (read from the JAX script's own source, which runs at
import), a narrowed ``train_small_torch.main`` lowers the loss, and a
narrowed ``serve_interference_torch.main`` serves every query of every
section with summaries that carry the JAX trace's keys.  Nothing here
asserts on a host time."""
import ast
import dataclasses
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import simulate, synthetic_database  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


serve_ex = _load("serve_interference_torch")
train_ex = _load("train_small_torch")


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' many small ops on one CPU thread: beside other test
    workers, a full thread pool a worker spends its time in barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name):
    """The JAX example's top-level constants, its ``cfg`` (evaluated from
    the script's own expression, without running the script) and its
    parsed tree."""
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    consts, cfg_expr = {}, None
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if not isinstance(target, ast.Name):
                continue
            if isinstance(node.value, ast.Constant):
                consts[target.id] = node.value.value
            elif target.id == "cfg":
                cfg_expr = node.value
    ns = dict(consts, dataclasses=dataclasses, get_smoke_config=jax_smoke)
    cfg = eval(compile(ast.Expression(cfg_expr), name, "eval"), ns)
    return consts, cfg, tree


def _same_config(port_cfg, jax_cfg):
    port, ref = dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg)
    assert port == ref
    assert port_cfg.param_count() == jax_cfg.param_count()


def test_serve_example_defaults_equal_jax():
    consts, cfg, tree = _jax_script("serve_interference")
    _same_config(serve_ex.default_config(), cfg)
    for name in ("ARCH", "NUM_EPS", "NUM_QUERIES", "SEQ"):
        assert getattr(serve_ex, name) == consts[name], name
    # The JAX schedule's episodes: EP2 x3.0 for 15-45, EP0 x2.2 for 50-70.
    schedule = serve_ex.make_schedule(serve_ex.NUM_EPS, serve_ex.EPISODES)
    want = {q: [1.0] * 4 for q in range(serve_ex.NUM_QUERIES)}
    for q in range(15, 45):
        want[q][2] = 3.0
    for q in range(50, 70):
        want[q][0] = 2.2
    assert all(schedule(q) == want[q] for q in want)
    src = ast.unparse(tree)
    assert "if 15 <= q < 45" in src and "if 50 <= q < 70" in src


def test_train_example_defaults_equal_jax():
    consts, cfg, tree = _jax_script("train_small")
    _same_config(train_ex.default_config(), cfg)
    src = ast.unparse(tree)
    assert "default=300" in src and train_ex.STEPS == 300
    assert ("AdamWConfig(lr=0.0006, warmup_steps=30, "
            "total_steps=args.steps)") in src
    assert ("SyntheticLM(cfg.vocab_size, seq_len=128, global_batch=4, "
            "seed=0)") in src


def test_train_example_lowers_the_loss(tmp_path):
    cfg = dataclasses.replace(train_ex.default_config(), num_layers=2,
                              d_model=128, num_heads=4, num_kv_heads=2,
                              head_dim=32, d_ff=256, vocab_size=512)
    out = train_ex.main(steps=30, checkpoint_dir=str(tmp_path),
                        device="cpu", cfg=cfg, log_every=10,
                        log_fn=lambda *_: None)
    first, last = out["history"][0], out["history"][-1]
    assert last["step"] == 29
    assert last["loss"] < first["loss"]


def test_serve_example_serves_every_query():
    cfg = dataclasses.replace(serve_ex.default_config(), num_layers=2)
    n = 24
    # The JAX schedule's two episodes, scaled from 80 queries to n.
    episodes = tuple((lo * n // 80, hi * n // 80, ep, f)
                     for lo, hi, ep, f in serve_ex.EPISODES)
    out = serve_ex.main(device="cpu", cfg=cfg, num_queries=n,
                        episodes=episodes)
    keys = set(simulate(synthetic_database("vgg16", seed=0), 4,
                        scheduler="odin", num_queries=20,
                        seed=0).summary())
    assert set(out["schedulers"]) == {"odin", "lls", "hybrid", "none"}
    summaries = (list(out["schedulers"].values())
                 + list(out["bursty"].values()) + list(out["mixed"].values()))
    assert len(summaries) == 8
    for s in summaries:
        assert set(s) == keys
    assert len(out["served"]) == 8
    assert all(v == n for v in out["served"].values()), out["served"]
    assert isinstance(out["acct_match"], bool)
