"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``), leaf by leaf.

The reference is called on ``jax.sharding.AbstractMesh`` meshes and on
its ``Model.params_spec()`` / ``cache_spec()`` trees (abstract: nothing
is allocated), the port on a plain mesh stand-in and on its ``meta``
trees.  The reference stacks each layer group on a leading ``n_repeat``
axis; the port unrolls layers, so each of the port's layer leaves is
compared with the reference's spec without its stack dim.  All ten
archs at full size, six meshes (the two pod shapes, three four-way ones
and an elastic 3 x 5), ``REPRO_OPT_SHARDING`` off and on.
"""

import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.testing.hypothesis_compat import given, settings, st  # noqa: E402

ARCHS = list(registry.ARCHS)
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "3x5": ((3, 5), ("data", "model")),
}
OPT = ["0", "1"]


def _meshes(key):
    sizes, names = MESHES[key]
    port = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))
    return AbstractMesh(sizes, names), port


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jbuild(jreg.get_config(arch)).params_spec()


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return build_model(registry.get_config(arch)).params_spec()


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]


def _ref_to_port(shapes, specs):
    """Every leaf of the reference's params as ``(port name, shape,
    spec, stacked)``: a stacked group's leaf once per unrolled layer, under
    the port's ``layers.<i>.`` / ``enc_layers.<i>.`` names."""
    out = []
    groups = {"groups": "layers", "dec_groups": "layers", "enc_groups": "enc_layers"}
    for key, sub in shapes.items():
        flat = list(zip(_flat(sub), _flat(specs[key])))
        if key not in groups:
            for (path, leaf), (_, spec) in flat:
                out.append((".".join([key] + [str(p.key) for p in path]), leaf.shape,
                            spec, False))
            continue
        layer = 0
        for g in range(len(sub)):
            gflat = list(zip(_flat(sub[g]), _flat(specs[key][g])))
            for _ in range(gflat[0][0][1].shape[0]):
                for (path, leaf), (_, spec) in gflat:
                    name = ".".join([f"{groups[key]}.{layer}"] + [str(p.key) for p in path])
                    out.append((name, leaf.shape, spec, True))
                layer += 1
    return out


@pytest.mark.parametrize("opt", OPT)
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(monkeypatch, arch, mesh_key, opt):
    monkeypatch.setenv("REPRO_OPT_SHARDING", opt)
    jmesh, mesh = _meshes(mesh_key)
    ref_tree = _ref_params(arch)
    pairs = _ref_to_port(ref_tree, jrules.param_specs(jmesh, ref_tree))
    got = rules.param_specs(mesh, _port_params(arch))
    assert {p[0] for p in pairs} == set(got)
    for name, shape, spec, stacked in pairs:
        want = tuple(spec)[1:] if stacked else tuple(spec)
        assert got[name] == want, (name, shape, spec)


@pytest.mark.parametrize("opt", OPT)
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_data_spec_matches_reference(monkeypatch, arch, mesh_key, opt):
    monkeypatch.setenv("REPRO_OPT_SHARDING", opt)
    jmesh, mesh = _meshes(mesh_key)
    jm, m = jbuild(jreg.get_config(arch)), build_model(registry.get_config(arch))
    for shape in SHAPES.values():
        ref = jrules.data_spec(jmesh, jm.input_specs(shape))
        got = rules.data_spec(mesh, m.input_specs(shape))
        assert got == {k: tuple(v) for k, v in ref.items()}, shape.name


def _cache_pairs(shapes, specs):
    """(port layer index, slot, leaf name, reference spec) for every
    reference cache leaf, once per unrolled layer."""
    out, layer = [], 0
    for g, group in enumerate(shapes["groups"]):
        leaves = list(zip(_flat(group), _flat(specs["groups"][g])))
        n = leaves[0][0][1].shape[0] if leaves else 0
        for i in range(n):
            for (path, _), (_, spec) in leaves:
                out.append((layer + i, str(path[0].key), str(path[1].key), spec))
        layer += n
    return out


@pytest.mark.parametrize("opt", OPT)
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches_reference(monkeypatch, arch, mesh_key, opt):
    monkeypatch.setenv("REPRO_OPT_SHARDING", opt)
    jmesh, mesh = _meshes(mesh_key)
    jcfg, cfg = jreg.get_config(arch), registry.get_config(arch)
    jm, m = jbuild(jcfg), build_model(cfg)
    for shape in SHAPES.values():
        if not shape_applicable(cfg, shape)[0]:
            continue
        jtree, cache = jm.cache_spec(shape), m.cache_spec(shape)
        for seq_sharded in (False, True):
            ref = jrules.cache_spec(jmesh, jtree, seq_sharded=seq_sharded)
            got = rules.cache_spec(mesh, cache, seq_sharded=seq_sharded)
            pairs = _cache_pairs(jtree, ref)
            assert len(pairs) == sum(len(s) for layer in got for s in layer.values())
            for layer, slot, leaf, spec in pairs:
                assert got[layer][slot][leaf] == tuple(spec)[1:], (
                    shape.name, seq_sharded, layer, slot, leaf)
            assert tuple(ref["pos"]) == rules.cache_leaf_spec(mesh, (), seq_sharded=seq_sharded)


@pytest.mark.parametrize("opt", OPT)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_decode_seq_axes_matches_reference(monkeypatch, mesh_key, opt):
    monkeypatch.setenv("REPRO_OPT_SHARDING", opt)
    jmesh, mesh = _meshes(mesh_key)
    try:
        for b, s in [(1, 524288), (128, 32768), (2, 64), (1, 60), (3, 15), (4, 4), (1, 7)]:
            jrules.set_active_mesh(None)
            rules.set_active_mesh(None)
            assert rules.decode_seq_axes(b, s) == jrules.decode_seq_axes(b, s) == ()
            jrules.set_active_mesh(jmesh)
            rules.set_active_mesh(mesh)
            assert rules.decode_seq_axes(b, s) == jrules.decode_seq_axes(b, s), (b, s)
    finally:
        jrules.set_active_mesh(None)
        rules.set_active_mesh(None)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 4, 4))
    assert rules.to_placements(mesh, (("pod", "data"), "model")) == [
        Shard(0), Shard(0), Shard(1)]
    assert rules.to_placements(mesh, (None, ("pod", "data", "model"))) == [Shard(1)] * 3
    assert rules.to_placements(mesh, ("model", None)) == [Replicate(), Replicate(), Shard(0)]
    assert rules.to_placements(mesh, ()) == [Replicate()] * 3


def test_constrain_is_the_identity_without_a_mesh_or_on_a_plain_tensor():
    x = torch.ones(4, 8)
    assert rules.constrain(x, "B", "model") is x
    rules.set_active_mesh(types.SimpleNamespace(axis_names=("data", "model"),
                                                shape={"data": 2, "model": 2}))
    try:
        assert rules.constrain(x, "B", "model") is x
    finally:
        rules.set_active_mesh(None)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 8), st.integers(1, 8), st.integers(0, 1), st.integers(0, len(ARCHS) - 1))
def test_param_specs_divide_their_axes(n_data, n_model, opt, arch_i):
    """On any mesh, every sharded dim divides its axes' product."""
    import os

    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": n_data, "model": n_model})
    old = os.environ.get("REPRO_OPT_SHARDING")
    os.environ["REPRO_OPT_SHARDING"] = str(opt)
    try:
        leaves = _port_params(ARCHS[arch_i])
        for name, spec in rules.param_specs(mesh, leaves).items():
            shape = leaves[name].shape
            assert len(spec) == len(shape), name
            for dim, s in zip(shape, spec):
                if s is not None:
                    axes = s if isinstance(s, tuple) else (s,)
                    n = 1
                    for a in axes:
                        n *= mesh.shape[a]
                    assert dim % n == 0, (name, shape, spec)
    finally:
        if old is None:
            os.environ.pop("REPRO_OPT_SHARDING")
        else:
            os.environ["REPRO_OPT_SHARDING"] = old
