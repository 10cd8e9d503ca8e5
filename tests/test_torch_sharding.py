"""The port's sharding rules (``repro_torch.launch.sharding``), production
mesh (``launch/mesh.make_production_mesh``) and activation constraint
(``models/sharding_ctx``) against the JAX package's, on the CPU.

JAX's rules run on an ``AbstractMesh`` of the production shape (they read
only its shape and axis names); the port's on ``make_production_mesh``
over a fake process group of 512 ranks on the meta device.  Every leaf's
spec must equal JAX's ``PartitionSpec``, its DTensor placements JAX's spec
translated one mesh axis at a time, and its shard shape
``NamedSharding.shard_shape``.  The constraint is held against what XLA
makes of ``with_sharding_constraint`` on 512 host devices, in a
subprocess.
"""
import functools
import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.launch import sharding as jax_sh  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import sharding_ctx  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STRATEGIES = ("tp", "zero3", "dp_seq", "fsdp_all")


@pytest.fixture
def meshes():
    """Both production meshes over one fake group of 512 ranks, destroyed
    after the test."""
    with port_mesh.production_group(512):
        yield {"16x16": port_mesh.make_production_mesh(device="meta"),
               "2x16x16": port_mesh.make_production_mesh(multi_pod=True,
                                                         device="meta")}


def _abstract(name):
    return AbstractMesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_steps.param_shapes(jax_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return steps.param_shapes(get_config(arch))


def _flat(tree):
    """{path/joined/by/slashes: LeafSharding}."""
    if isinstance(tree, sh.LeafSharding):
        return {"": tree}
    out = {}
    for k, v in tree.items():
        for p, leaf in _flat(v).items():
            out[f"{k}/{p}" if p else k] = leaf
    return out


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
    return {jax.tree_util.keystr(p, simple=True, separator="/"): s
            for p, s in flat}


def _translate(spec, axis_names):
    """JAX's spec as DTensor placements, one mesh axis at a time."""
    out = []
    for a in axis_names:
        dims = [d for d, e in enumerate(spec) if e is not None
                and a in ((e,) if isinstance(e, str) else tuple(e))]
        assert len(dims) <= 1
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _assert_same(got, want, shapes, amesh):
    """Port shardings ``got`` against JAX's ``want`` leaf by leaf."""
    got, want = _flat(got), _jax_flat(want)
    assert sorted(got) == sorted(want)
    for key, ls in got.items():
        ns = want[key]
        assert P(*ls.spec) == ns.spec, key
        assert ls.placements == _translate(ns.spec, amesh.axis_names), key
        assert ls.shard_shape == tuple(ns.shard_shape(shapes[key])), key


def _jax_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p, simple=True, separator="/"):
            tuple(x.shape) for p, x in flat}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_zero1_shardings_equal_jax(meshes, arch, mesh_name,
                                              strategy):
    mesh, amesh = meshes[mesh_name], _abstract(mesh_name)
    jparams = _jax_params(arch)
    shapes = _jax_shapes(jparams)
    want = jax_sh.params_shardings(jparams, amesh, strategy=strategy,
                                   cfg=jax_config(arch))
    got = sh.params_shardings(_port_params(arch), mesh, strategy=strategy,
                              cfg=get_config(arch))
    _assert_same(got, want, shapes, amesh)
    # ZeRO-1: the moments' shardings and the replicated count.  Under
    # dp_seq a weight already sharded over the data axes can get them on
    # a second dim; JAX's NamedSharding refuses that, and so does the port.
    jopt = jax_steps.opt_state_shapes(jparams)
    port_opt = steps.opt_state_shapes(_port_params(arch))
    try:
        want_opt = jax_sh.opt_state_shardings(jopt, want, amesh,
                                              strategy=strategy)
    except Exception as e:  # noqa: BLE001 (JAX's DuplicateSpecError)
        assert "duplicate entries" in str(e)
        with pytest.raises(ValueError, match="twice"):
            sh.opt_state_shardings(port_opt, got, mesh, strategy=strategy)
        assert strategy == "dp_seq"
        return
    got_opt = sh.opt_state_shardings(port_opt, got, mesh, strategy=strategy)
    _assert_same(got_opt, want_opt, _jax_shapes(jopt), amesh)


def _inputs(arch, shape_name):
    shape = INPUT_SHAPES[shape_name]
    cfg = steps.resolve_config(get_config(arch), shape)
    jcfg = jax_steps.resolve_config(jax_config(arch), shape)
    return (steps.input_specs(cfg, shape),
            jax_steps.input_specs(jcfg, shape), shape)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_batch_shardings_equal_jax(meshes, shape_name, strategy):
    """batch_pspec over every input leaf of the shape (the cache's too),
    for a dense decoder, a Mamba2 model and an embedding-input encoder."""
    for arch in ("qwen3-8b", "mamba2-370m", "hubert-xlarge"):
        if arch == "hubert-xlarge" and INPUT_SHAPES[shape_name].mode == \
                "decode":
            continue
        port, jspecs, _ = _inputs(arch, shape_name)
        for name, mesh in meshes.items():
            amesh = _abstract(name)
            _assert_same(sh.batch_pspec(port, mesh, strategy),
                         jax_sh.batch_pspec(jspecs, amesh, strategy),
                         _jax_shapes(jspecs), amesh)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if get_config(a).is_decoder])
def test_cache_shardings_equal_jax(meshes, arch, shape_name):
    port, jspecs, shape = _inputs(arch, shape_name)
    for name, mesh in meshes.items():
        amesh = _abstract(name)
        _assert_same(
            sh.cache_shardings(port["cache"], mesh, shape.global_batch),
            jax_sh.cache_shardings(jspecs["cache"], amesh,
                                   shape.global_batch),
            _jax_shapes(jspecs["cache"]), amesh)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_equals_jax(meshes, monkeypatch, multi_pod):
    monkeypatch.setattr(jax_mesh, "build_mesh",
                        lambda shape, axes: AbstractMesh(tuple(shape),
                                                         tuple(axes)))
    want = jax_mesh.make_production_mesh(multi_pod=multi_pod)
    got = meshes["2x16x16" if multi_pod else "16x16"]
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert list(got.shape) == list(want.shape)
    assert port_mesh.data_axes(got) == jax_mesh.data_axes(want)
    assert got.backend == "fake" and got.device == torch.device("meta")
    assert got.coords == {a: 0 for a in got.axis_names}


@pytest.mark.parametrize("arch,strategy,kind", [
    ("qwen3-32b", "zero3", "params"),     # weights over (pod, data) + model
    ("deepseek-moe-16b", "fsdp_all", "batch"),   # batch over the whole mesh
    ("qwen3-8b", "tp", "cache"),          # cache batch + sequence
])
def test_dtensor_shards_equal_jax_shard_shape(meshes, arch, strategy, kind):
    """A meta DTensor with a leaf's placements on a DeviceMesh over the
    fake group holds JAX's shard shape."""
    mesh, amesh = meshes["2x16x16"], _abstract("2x16x16")
    dmesh = sh.device_mesh(mesh)
    if kind == "params":
        tree = jax_sh.params_shardings(_jax_params(arch), amesh, strategy,
                                       cfg=jax_config(arch))
        got = sh.params_shardings(_port_params(arch), mesh, strategy,
                                  cfg=get_config(arch))
        shapes = _jax_shapes(_jax_params(arch))
    else:
        shape_name = "train_4k" if kind == "batch" else "decode_32k"
        port, jspecs, shape = _inputs(arch, shape_name)
        if kind == "batch":
            tree = jax_sh.batch_pspec(jspecs, amesh, strategy)
            got = sh.batch_pspec(port, mesh, strategy)
            shapes = _jax_shapes(jspecs)
        else:
            tree = jax_sh.cache_shardings(jspecs["cache"], amesh, 128)
            got = sh.cache_shardings(port["cache"], mesh, 128)
            shapes = _jax_shapes(jspecs["cache"])
    want = _jax_flat(tree)
    sharded = [(k, ls) for k, ls in _flat(got).items()
               if any(isinstance(p, Shard) for p in ls.placements)]
    assert sharded
    for key, ls in sharded[:4]:
        assert sh.dtensor_shard_shape(ls, dmesh) == tuple(
            want[key].shard_shape(shapes[key])), key


def test_sharded_bytes_sum_the_shards(meshes):
    got = sh.params_shardings(_port_params("qwen2-0.5b"), meshes["16x16"],
                              "zero3", cfg=get_config("qwen2-0.5b"))
    want = sum(ls.shard_bytes for ls in _flat(got).values())
    assert sh.sharded_bytes(got) == want
    assert want < sum(t.numel() * 2 for t in _flat_tensors(
        _port_params("qwen2-0.5b")))


def _flat_tensors(tree):
    for v in tree.values():
        yield from (_flat_tensors(v) if isinstance(v, dict) else [v])


def test_fake_group_runs_only_on_the_meta_device():
    with port_mesh.production_group(256):
        for device in (None, "cpu"):
            with pytest.raises(ValueError, match="meta"):
                port_mesh.make_production_mesh(device=device)
        with pytest.raises(ValueError, match="ranks, have 256"):
            port_mesh.make_production_mesh(multi_pod=True, device="meta")
        with pytest.raises(RuntimeError, match="exists already"):
            with port_mesh.production_group(512):
                pass
        assert port_mesh.make_production_mesh(device="meta").rank == 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="256, 512"):
        with port_mesh.production_group(8):
            pass


def test_constrain_without_a_spec_returns_its_input():
    x = torch.zeros(2, 3, 4)
    n = sharding_ctx.constrained
    assert sharding_ctx.constrain(x) is x
    assert sharding_ctx.constrained == n
    with pytest.raises(RuntimeError, match="mesh"):
        sharding_ctx.set_activation_spec((("data",), None, None))


# (activation shape, spec) on the 2x16x16 mesh: even and padded splits,
# a short spec, and the specs XLA refuses.
CONSTRAIN_CASES = [
    ((64, 8, 16), [["pod", "data"], None, None]),
    ((48, 8, 16), [["pod", "data", "model"], None, None]),   # 48 / 512
    ((48, 8, 16), [["pod", "data"], None, None]),            # 48 / 32
    ((32, 32, 16), [["pod", "data"], "model", None]),
    ((4, 24, 16), [["pod"], "model", None]),                 # 24 / 16
    ((64, 8, 16), ["data"]),
    ((4, 8), ["data", None, None]),                          # too long
    ((4, 8, 16), ["data", "data", None]),                    # twice
    ((4, 8, 16), ["stage", None, None]),                     # no such axis
]

CONSTRAIN_SCRIPT = r'''
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_production_mesh

mesh = make_production_mesh(multi_pod=True)
out = []
for shape, spec in json.loads(sys.argv[1]):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    f = jax.jit(lambda x: jnp.sin(jax.lax.with_sharding_constraint(
        jnp.cos(x), spec)))
    try:
        with mesh:
            hlo = f.lower(jax.ShapeDtypeStruct(tuple(shape),
                                               jnp.float32)).compile().as_text()
    except Exception as e:
        out.append(["raises", type(e).__name__])
        continue
    line = next(l for l in hlo.splitlines() if " cosine(" in l)
    dims = re.search(r"= f32\[([0-9,]*)\]", line).group(1)
    out.append(["shard", [int(d) for d in dims.split(",")]])
print(json.dumps(out))
'''


def test_constrain_checks_the_spec_as_xla_lowers_it():
    """Held against XLA: a dim its axes do not divide is sharded padded up
    (each device holds the ceiling), where the spec is too long, names an
    axis twice or an axis the mesh lacks it raises."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", CONSTRAIN_SCRIPT,
                        json.dumps(CONSTRAIN_CASES)], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    with port_mesh.production_group(512):
        mesh = port_mesh.make_production_mesh(multi_pod=True, device="meta")
        for (shape, spec), (kind, got_jax) in zip(CONSTRAIN_CASES, want):
            spec = tuple(tuple(e) if isinstance(e, list) else e
                         for e in spec)
            x = torch.empty(shape, device="meta")
            try:
                with sharding_ctx.activation_spec(spec, mesh):
                    n = sharding_ctx.constrained
                    assert sharding_ctx.constrain(x) is x
                    assert sharding_ctx.constrained == n + 1
                got = ["shard", list(sharding_ctx.last_shard_shape)]
            except ValueError:
                got = ["raises", None]
            assert got[0] == kind, (shape, spec, got_jax)
            if kind == "shard":
                assert got[1] == got_jax, (shape, spec)
    assert sharding_ctx._ACTIVATION is None
