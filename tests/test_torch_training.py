"""The port's training path against the JAX package's on the CPU: the
optimizer, the synthetic data, the loss and its gradients at every smoke
arch, remat, checkpoints crossing between the packages, a short train
history, the train CLI and the analytic cost model's copy."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import analytic as jax_analytic  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.training import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import analytic  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.training import AdamWConfig, train  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import data  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.train_loop import (  # noqa: E402
    loss_and_grads,
    to_batch,
)

# Model.loss against jax.value_and_grad(model.loss): the loss to LOSS_RTOL
# relative, each gradient leaf's rms error to GRAD_RMS_LIMIT of its rms.
# Both sum in fp32 in different orders.
LOSS_RTOL = 1e-5
GRAD_RMS_LIMIT = 1e-4
SEQ, BATCH = 32, 2


def _np(x):
    return np.asarray(x, np.float32)


def _flat_np(tree, prefix=""):
    """{keystr-like path: numpy array} of a nested dict of arrays or
    tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}[{k!r}]"
        if isinstance(v, dict):
            out.update(_flat_np(v, p))
        else:
            out[p] = (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                      else np.asarray(v, np.float32))
    return out


def _rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _batch(cfg, seed=0):
    if cfg.embedding_inputs:
        return data.SyntheticEmbeds(cfg.d_model, cfg.vocab_size, SEQ, BATCH,
                                    seed=seed).batch_at(0)
    return data.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=seed).batch_at(0)


def _jax_init(cfg, seed=0):
    params = JaxModel(cfg).init_params(jax.random.PRNGKey(seed), jnp.float32)
    return params, params_from_jax(jax.tree.map(np.asarray, params),
                                   device="cpu")


# -- optimizer ----------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 150])
def test_lr_schedule_matches_jax(step):
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = float(opt.lr_schedule(AdamWConfig(**kw), step))
    want = float(jax_opt.lr_schedule(JaxAdamWConfig(**kw), jnp.array(step)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def _tree(rng, scale=1.0):
    return {"a": {"w": rng.standard_normal((8, 16)).astype(np.float32) * scale,
                  "b": rng.standard_normal(16).astype(np.float32) * scale},
            "z": rng.standard_normal((3, 4, 5)).astype(np.float32) * scale}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["no_clip", "clip"])
def test_adamw_update_matches_jax(grad_scale):
    """Two steps from zero state, against JAX's, to 1e-6; with the larger
    gradients the global norm is above grad_clip, so the clip bites."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(2)]
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jax_opt.init_adamw(jp), opt.init_adamw(tp)
    for g in grads:
        jp, js, jm = jax_opt.adamw_update(JaxAdamWConfig(**kw), jp,
                                          jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = opt.adamw_update(AdamWConfig(**kw), tp, _to_torch(g),
                                      ts)
        assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 2
    assert ts["count"].dtype == torch.int32
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        g, w = _flat_np(got), _flat_np(jax.tree.map(np.asarray, want))
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_adamw_keeps_param_dtype_and_inputs():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.init_adamw(params)
    new_p, new_s, _ = opt.adamw_update(
        AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10), params,
        {"w": torch.ones(4)}, state)
    assert new_p["w"].dtype == torch.bfloat16
    assert bool((new_p["w"] < 1).all())
    assert bool((params["w"] == 1).all()) and int(state["count"]) == 0
    assert new_s["m"]["w"].dtype == torch.float32


# -- data and the loss --------------------------------------------------------


@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_batches_equal_the_originals(step):
    for port, ref in (
            (data.SyntheticLM(1000, 32, 4, seed=1),
             jax_data.SyntheticLM(1000, 32, 4, seed=1)),
            (data.SyntheticEmbeds(64, 100, 16, 2, seed=3),
             jax_data.SyntheticEmbeds(64, 100, 16, 2, seed=3))):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 8, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) < 0.6).astype(np.float32) if masked else None
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    want = jax_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None
                                    else jnp.asarray(mask))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_jax(arch):
    """Model.loss and every gradient leaf against jax.value_and_grad of the
    JAX model's loss, on the same weights and batch."""
    cfg = get_smoke_config(arch)
    jparams, tparams = _jax_init(jax_smoke(arch))
    batch = _batch(cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        JaxModel(jax_smoke(arch)).loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, batch))
    (tloss, tmet), tgrads = loss_and_grads(Model(cfg), tparams,
                                           to_batch(batch, "cpu"))
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    assert tmet.keys() == jmet.keys()
    for k in tmet:
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=LOSS_RTOL,
                                               abs=1e-6), k
    got, want = _flat_np(tgrads), _flat_np(jax.tree.map(np.asarray, jgrads))
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        err = _rms(got[k] - want[k])
        assert err <= GRAD_RMS_LIMIT * _rms(want[k]) or err == 0.0, (
            k, err, _rms(want[k]))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-1.5-large-398b"])
def test_remat_gives_the_same_grads(arch):
    cfg = get_smoke_config(arch)
    _, params = _jax_init(jax_smoke(arch))
    batch = to_batch(_batch(cfg, seed=4), "cpu")
    (l0, _), g0 = loss_and_grads(Model(cfg, remat=False), params, batch)
    (l1, _), g1 = loss_and_grads(Model(cfg, remat=True), params, batch)
    assert float(l0) == float(l1)
    for a, b in zip(opt.leaves(g0), opt.leaves(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- checkpoints --------------------------------------------------------------


def _states(arch="qwen2-0.5b"):
    """(JAX tree, port tree) of params and an AdamW state after one step,
    so m, v and count are not zero."""
    jparams, tparams = _jax_init(jax_smoke(arch))
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        jparams)
    c = JaxAdamWConfig(warmup_steps=1)
    jparams, jstate, _ = jax_opt.adamw_update(c, jparams, grads,
                                              jax_opt.init_adamw(jparams))
    jtree = {"params": jparams, "opt": jstate}
    ttree = {"params": params_from_jax(jax.tree.map(np.asarray, jparams),
                                       device="cpu"),
             "opt": opt.init_adamw(tparams)}
    return jtree, ttree


def _assert_trees_equal(port, jax_tree):
    got, want = _flat_np(port), _flat_np(jax.tree.map(np.asarray, jax_tree))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_checkpoint_from_jax_loads_in_port(tmp_path):
    jtree, ttree = _states()
    jax_ckpt.save_checkpoint(str(tmp_path), jtree, step=7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    ttree["opt"] = opt.init_adamw(ttree["params"])      # zeros, count 0
    loaded = ckpt.load_checkpoint(str(tmp_path), ttree)
    _assert_trees_equal(loaded, jtree)
    assert int(loaded["opt"]["count"]) == 1
    assert loaded["opt"]["count"].dtype == torch.int32


def test_checkpoint_from_port_loads_in_jax(tmp_path):
    jtree, ttree = _states()
    ttree["opt"] = _port_opt(jtree)
    ckpt.save_checkpoint(str(tmp_path), ttree, step=3)
    assert jax_ckpt.latest_step(str(tmp_path)) == 3
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["latest.json", "step-3.npz"]          # no .tmp left
    like = jax.tree.map(jnp.zeros_like, jtree)
    loaded = jax_ckpt.load_checkpoint(str(tmp_path), like)
    _assert_trees_equal(ttree, loaded)
    assert int(loaded["opt"]["count"]) == 1


def _port_opt(jtree):
    """The JAX opt state as port tensors (count int32)."""
    s = jax.tree.map(np.asarray, jtree["opt"])
    return {"m": params_from_jax(s["m"], device="cpu"),
            "v": params_from_jax(s["v"], device="cpu"),
            "count": torch.tensor(int(s["count"]), dtype=torch.int32)}


def test_checkpoint_widens_bf16_as_jax_does(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0, 0.1],
                                    dtype=torch.bfloat16)}}
    ckpt.save_checkpoint(str(tmp_path), tree, step=5)
    with np.load(tmp_path / "step-5.npz") as f:
        assert sorted(f.files) == ["['a']", "['b']['c']"]
        assert f["['b']['c']"].dtype == np.float32
    like = {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4, jnp.bfloat16)}}
    loaded = jax_ckpt.load_checkpoint(str(tmp_path), like)
    assert loaded["b"]["c"].dtype == jnp.bfloat16
    back = ckpt.load_checkpoint(str(tmp_path), tree)
    assert back["b"]["c"].dtype == torch.bfloat16
    for x, y in zip(opt.leaves(tree), opt.leaves(back)):
        assert torch.equal(x, y)


# -- the train loop and the CLI -----------------------------------------------


def test_train_history_matches_jax():
    """3 steps of qwen2-0.5b smoke from the same weights and data: the
    logged metrics against JAX train()'s, to 1e-4."""
    cfg = get_smoke_config("qwen2-0.5b")
    jparams, tparams = _jax_init(jax_smoke("qwen2-0.5b"))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    stream = lambda: iter(data.SyntheticLM(cfg.vocab_size, SEQ, 4, seed=2))  # noqa: E731
    want = jax_train(jax_smoke("qwen2-0.5b"), JaxAdamWConfig(**kw), stream(),
                     3, params=jparams, log_every=1, log_fn=lambda *_: None)
    lines = []
    got = train(cfg, AdamWConfig(**kw), stream(), 3, device="cpu",
                params=tparams, log_every=1, log_fn=lines.append)
    assert len(lines) == 3 and lines[0].startswith("step     0 loss=")
    assert len(got["history"]) == len(want["history"]) == 3
    for g, w in zip(got["history"], want["history"]):
        assert g.keys() == w.keys()
        assert g["step"] == w["step"] and g["wall_s"] > 0
        for k in ("loss", "ce", "grad_norm", "lr", "aux_loss", "router_z",
                  "dropped_frac"):
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k
    assert int(got["opt_state"]["count"]) == 3


def test_train_loss_decreases():
    """The port's mirror of tests/test_training.py's test."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), num_layers=2)
    stream = data.SyntheticLM(cfg.vocab_size, 64, 8, seed=0)
    out = train(cfg, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30),
                iter(stream), 30, device="cpu", log_every=29,
                log_fn=lambda *_: None)
    h = out["history"]
    assert [m["step"] for m in h] == [0, 29]
    assert h[-1]["loss"] < h[0]["loss"]


def test_train_checkpoints_on_the_jax_cadence(tmp_path):
    cfg = get_smoke_config("qwen2-0.5b")
    stream = data.SyntheticLM(cfg.vocab_size, 16, 2, seed=0)
    out = train(cfg, AdamWConfig(warmup_steps=1, total_steps=5), iter(stream),
                5, device="cpu", checkpoint_dir=str(tmp_path),
                checkpoint_every=2, log_fn=lambda *_: None)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(p.name for p in tmp_path.glob("step-*.npz")) == [
        "step-2.npz", "step-4.npz"]
    like = {"params": out["params"], "opt": out["opt_state"]}
    # The checkpoint at step index 4 holds the state after 5 updates.
    assert int(ckpt.load_checkpoint(str(tmp_path), like)["opt"]["count"]) == 5


def test_train_cli_on_cpu(capsys):
    train_cli.main(["--device", "cpu", "--steps", "3", "--seq", "32",
                    "--batch", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("training qwen2-0.5b-smoke: 2 blocks")
    assert [ln.split()[1] for ln in out[1:]] == ["0", "2"]


def test_train_cli_on_cpu_with_defaults(capsys):
    """--steps 3 and the JAX CLI's other defaults (seq 256, batch 8)."""
    train_cli.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and all(np.isfinite(float(ln.split("loss=")[1]
                                                   .split()[0]))
                                 for ln in out[1:])


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(get_smoke_config("qwen2-0.5b"), AdamWConfig(), iter([]), 1)


# -- the analytic cost model --------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_copy_matches_the_original(arch):
    for jshape in JAX_SHAPES.values():
        shape = InputShape(**dataclasses.asdict(jshape))
        for remat in (True, False):
            got = analytic.analytic_totals(get_config(arch), shape, remat)
            want = jax_analytic.analytic_totals(jax_get_config(arch),
                                                jshape, remat)
            assert got == want
