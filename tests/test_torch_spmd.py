"""The port's SPMD stage pipeline (``repro_torch.pipeline.spmd``,
``repro_torch.launch.mesh``) against the JAX package's, on the CPU.

Mirrors ``tests/test_pipeline.py::test_spmd_pipeline_subprocess``: the
8-layer qwen3-8b smoke model in fp32, ``B, S, M = 2, 32, 4``, cap 4, the
configs ``[2,2,2,2]``, ``[1,3,2,2]`` and ``[3,0,3,2]`` (one stage empty),
against JAX's per-microbatch monolithic forward at 1e-4.  The port's ranks
are 4 gloo processes, spawned once by a subprocess that imports no JAX;
they take the JAX weights through ``convert.params_from_jax``.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import blocks as jax_blk  # noqa: E402
from repro.models.layers import embed as jax_embed  # noqa: E402
from repro.pipeline import spmd as jax_spmd  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.pipeline.spmd import pack_stage_params  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = ([2, 2, 2, 2], [1, 3, 2, 2], [3, 0, 3, 2])
# model_parallel=2: two stages of two ranks each, cap 8.
TWO_STAGE_CONFIGS = ([4, 4], [1, 7], [8, 0])
# A 2-stage mesh on the first 2 of the 4 ranks, cap 8.
PART_CONFIG = [3, 5]
B, S, M, CAP = 2, 32, 4, 4
QUERY_ROWS, QUERY_M, QUERY_CONFIG = 3, 2, [3, 0, 3, 2]

# Run as a file by one subprocess, so that the spawned ranks can import
# its functions; it imports no JAX.  argv[1] is the work directory: the
# weights and inputs in, every rank's results out.
RANKS_SCRIPT = '''
import dataclasses, pathlib, pickle, sys
import numpy as np
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import data_axes, make_stage_mesh, spawn_ranks
from repro_torch.pipeline.spmd import (SpmdPipelineExecutor,
                                       pipelined_forward)

CONFIGS = {configs!r}
TWO_STAGE_CONFIGS = {two_stage!r}
PART_CONFIG = {part!r}
CAP, QUERY_M, QUERY_CONFIG = {cap!r}, {query_m!r}, {query_config!r}


def mesh_view(mesh):
    return dict(axis_names=mesh.axis_names, shape=mesh.shape,
                coords=mesh.coords, data_axes=data_axes(mesh),
                model_ranks=mesh.model_ranks, device=str(mesh.device))


def rank_main(rank, params, inputs, tokens):
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), num_layers=8)
    out = {{}}
    mesh = make_stage_mesh(4, device="cpu")
    out["mesh1"] = mesh_view(mesh)
    for c in CONFIGS:
        out[("b", str(c))] = pipelined_forward(
            cfg, mesh, params["blocks"], c, inputs, cap=CAP).numpy()
    ex = SpmdPipelineExecutor(cfg, params, 4, cap=CAP,
                              num_microbatches=QUERY_M, mesh=mesh)
    out["c"] = ex.run_query(tokens, QUERY_CONFIG).numpy()
    mesh2 = make_stage_mesh(2, model_parallel=2, device="cpu")
    out["mesh2"] = mesh_view(mesh2)
    for c in TWO_STAGE_CONFIGS:
        out[("d", str(c))] = pipelined_forward(
            cfg, mesh2, params["blocks"], c, inputs, cap=2 * CAP).numpy()
    try:
        part = make_stage_mesh(2, device="cpu")   # every rank takes part
    except ValueError as e:
        out["part"] = str(e)
    else:
        out["part"] = pipelined_forward(cfg, part, params["blocks"],
                                        PART_CONFIG, inputs,
                                        cap=2 * CAP).numpy()
    for what, build in (
            ("mesh", lambda: make_stage_mesh(4, model_parallel=2,
                                             device="cpu")),
            ("executor", lambda: SpmdPipelineExecutor(cfg, params, 8))):
        try:
            build()
        except ValueError as e:
            out[("e", what)] = str(e)
    return out


def failing_rank(rank):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


if __name__ == "__main__":
    work = pathlib.Path(sys.argv[1])
    flat = np.load(work / "params.npz")
    tree = {{}}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {{}})
        node[leaf] = flat[key]
    params = params_from_jax(tree, device="cpu")
    data = np.load(work / "inputs.npz")
    ranks = spawn_ranks(
        rank_main, 4, (params, torch.from_numpy(data["inputs"]),
                       torch.from_numpy(data["tokens"])),
        backend="gloo", init_file=str(work / "rendezvous"))
    try:
        spawn_ranks(failing_rank, 2, backend="gloo",
                    init_file=str(work / "rendezvous_fail"))
        failure = None
    except Exception as e:
        failure = f"{{type(e).__name__}}: {{e}}"
    with open(work / "ranks.pkl", "wb") as f:
        pickle.dump(dict(ranks=ranks, failure=failure), f)
'''


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX weights, the embedded microbatches, the per-microbatch
    monolithic reference (the JAX test's ``ref``) and the forward logits
    of the query rows."""
    cfg = dataclasses.replace(jax_smoke("qwen3-8b"), num_layers=8)
    model = JaxModel(cfg)
    params = model.init_params(jax.random.PRNGKey(0), jnp.float32)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (M, B, S), 0,
                                cfg.vocab_size)
    inputs = jax.vmap(lambda t: jax_embed(params["embed"], t))(tokens)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

    @jax.jit
    def ref(t):
        x = jax_embed(params["embed"], t)

        def body(c, bp):
            h, _ = jax_blk.block_forward(bp, cfg, c, pos)
            return h, None
        h, _ = jax.lax.scan(body, x, params["blocks"])
        return h
    refs = np.stack([np.asarray(ref(tokens[m])) for m in range(M)])
    query = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                              (QUERY_ROWS, S))
    logits, _ = model.forward(params, tokens=jnp.asarray(query))
    return dict(params=jax.tree.map(np.asarray, params),
                inputs=np.asarray(inputs), refs=refs, query=query,
                logits=np.asarray(logits))


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every rank's results, from one spawn of 4 gloo ranks."""
    work = tmp_path_factory.mktemp("spmd")
    np.savez(work / "params.npz", **dict(_flatten(jax_side["params"])))
    np.savez(work / "inputs.npz", inputs=jax_side["inputs"],
             tokens=jax_side["query"])
    script = work / "spmd_ranks.py"
    script.write_text(RANKS_SCRIPT.format(
        configs=CONFIGS, two_stage=TWO_STAGE_CONFIGS, part=PART_CONFIG,
        cap=CAP,
        query_m=QUERY_M, query_config=QUERY_CONFIG))
    env = {"PYTHONPATH": str(ROOT / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"),
           **{k: os.environ[k] for k in ("TMPDIR",) if k in os.environ}}
    r = subprocess.run([sys.executable, str(script), str(work)],
                       capture_output=True, text=True, env=env,
                       cwd=str(work), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(work / "ranks.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("config,cap", [(c, CAP) for c in CONFIGS]
                         + [(c, 2 * CAP) for c in TWO_STAGE_CONFIGS],
                         ids=str)
def test_pack_stage_params_bit_equal_to_jax(jax_side, config, cap):
    blocks = jax_side["params"]["blocks"]
    want = jax_spmd.pack_stage_params(
        jax.tree.map(jnp.asarray, blocks), config, cap)
    got = pack_stage_params(params_from_jax(blocks, device="cpu"), config,
                            cap)
    flat_want, flat_got = dict(_flatten(want)), dict(_flatten(got))
    assert flat_want.keys() == flat_got.keys()
    for k, w in flat_want.items():
        assert flat_got[k].shape == (len(config), cap) + w.shape[2:]
        assert np.array_equal(flat_got[k], w), k


@pytest.mark.parametrize("config", CONFIGS, ids=str)
def test_pipelined_forward_matches_jax(jax_side, ranks, config):
    outs = [r[("b", str(config))] for r in ranks["ranks"]]
    for out in outs[1:]:       # the outputs reach every rank
        assert np.array_equal(out, outs[0])
    err = np.max(np.abs(outs[0] - jax_side["refs"]))
    assert err < 1e-4, (config, err)


def test_run_query_matches_jax_forward(jax_side, ranks):
    """3 rows in 2 microbatches: one padding row, dropped."""
    for r in ranks["ranks"]:
        assert r["c"].shape == jax_side["logits"].shape
        np.testing.assert_allclose(r["c"], jax_side["logits"], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("config", TWO_STAGE_CONFIGS, ids=str)
def test_model_parallel_matches_one_axis(ranks, config):
    """2 stages x 2 model ranks: the same outputs as 4 stages of one."""
    want = ranks["ranks"][0][("b", str(CONFIGS[0]))]
    for r in ranks["ranks"]:
        assert np.array_equal(r[("d", str(config))], want)


def test_mesh_on_the_first_ranks_of_a_larger_group(ranks):
    """A 2-stage mesh in the 4-rank group: ranks 0 and 1 run it over their
    subgroup and give the 4-stage outputs; ranks 2 and 3 raise."""
    want = ranks["ranks"][0][("b", str(CONFIGS[0]))]
    for r in ranks["ranks"][:2]:
        assert np.array_equal(r["part"], want)
    for rank, r in enumerate(ranks["ranks"][2:], 2):
        assert r["part"] == f"rank {rank} lies outside the 2 mesh"


def test_mesh_coords_and_hand_off_ranks(ranks):
    for rank, r in enumerate(ranks["ranks"]):
        assert r["mesh1"]["coords"] == {"stage": rank}
        assert r["mesh1"]["model_ranks"] == (rank,)
        assert r["mesh2"]["coords"] == {"stage": rank // 2,
                                        "model": rank % 2}
        assert r["mesh2"]["model_ranks"] == (rank - rank % 2,
                                             rank - rank % 2 + 1)
        assert r["mesh1"]["device"] == "cpu"


@pytest.mark.parametrize("what,size", [("mesh", 8), ("executor", 8)])
def test_small_world_raises(ranks, what, size):
    for r in ranks["ranks"]:
        assert f"mesh needs >= {size} ranks, have 4" in r[("e", what)]


def test_spawn_ranks_raises_a_rank_failure(ranks):
    assert ranks["failure"] is not None
    assert "rank 1 fails on purpose" in ranks["failure"]


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_stage_mesh_matches_jax(ranks, monkeypatch, model_parallel):
    """Axis names, shape and data axes of JAX's make_stage_mesh (an
    AbstractMesh stands in for its devices) against the ranks' meshes."""
    monkeypatch.setattr(jax_mesh, "build_mesh",
                        lambda shape, axes: jax.sharding.AbstractMesh(
                            tuple(shape), tuple(axes)))
    stages = 4 // model_parallel
    want = jax_mesh.make_stage_mesh(stages, model_parallel=model_parallel)
    for r in ranks["ranks"]:
        got = r["mesh1" if model_parallel == 1 else "mesh2"]
        assert got["axis_names"] == tuple(want.axis_names)
        assert got["shape"] == dict(want.shape)
        assert list(got["shape"]) == list(want.shape)
        assert got["data_axes"] == jax_mesh.data_axes(want)
    assert port_mesh.data_axes(jax.sharding.AbstractMesh(
        (2, 2, 2), ("pod", "data", "model"))) == ("pod", "data")


@pytest.mark.parametrize("backend,rank,world,cards,device,want", [
    ("nccl", 2, 4, 4, None, "cuda:2"),
    ("nccl", 0, 4, 1, None, ValueError),      # two ranks on one card
    ("nccl", 1, 2, 2, "cuda:0", ValueError),  # not the rank's card
    ("gloo", 3, 4, 0, "cpu", "cpu"),
    ("mpi", 0, 1, 1, "cpu", ValueError),
])
def test_rank_device(monkeypatch, backend, rank, world, cards, device, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if want is ValueError:
        with pytest.raises(ValueError):
            port_mesh.rank_device(backend, rank, world, device)
    else:
        assert port_mesh.rank_device(backend, rank, world,
                                     device) == torch.device(want)


def test_gloo_rank_device_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        port_mesh.rank_device("gloo", 0, 1)
