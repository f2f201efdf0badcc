"""The port's dry-run specs (``Model.input_specs``, ``params_spec``,
``cache_spec``) against the reference's ``jax.eval_shape`` trees: every
arch at full size, every applicable shape, the same shapes and dtypes
leaf by leaf (the reference's stacked layer leaves once per unrolled
layer), and every tensor on the ``meta`` device — nothing allocated."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES, shape_applicable  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402

ARCHS = list(registry.ARCHS)
GROUPS = {"groups": "layers", "dec_groups": "layers", "enc_groups": "enc_layers"}
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if shape_applicable(registry.get_config(a), SHAPES[s])[0]]


def _dtype(jdt) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[np.dtype(jdt).name]


def _unstacked(tree) -> dict:
    """The reference's params tree as port name -> (shape, dtype)."""
    out = {}
    for key, sub in tree.items():
        if key not in GROUPS:
            for path, leaf in jax.tree_util.tree_flatten_with_path(sub)[0]:
                out[".".join([key] + [str(p.key) for p in path])] = (leaf.shape, leaf.dtype)
            continue
        layer = 0
        for group in sub:
            flat = jax.tree_util.tree_flatten_with_path(group)[0]
            for _ in range(flat[0][1].shape[0]):
                for path, leaf in flat:
                    name = ".".join([f"{GROUPS[key]}.{layer}"] + [str(p.key) for p in path])
                    out[name] = (leaf.shape[1:], leaf.dtype)
                layer += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_spec_matches_reference(arch):
    want = _unstacked(jbuild(jreg.get_config(arch)).params_spec())
    got = build_model(registry.get_config(arch)).params_spec()
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.device.type == "meta", name
        assert (tuple(t.shape), t.dtype) == (tuple(want[name][0]), _dtype(want[name][1])), name


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_and_cache_specs_match_reference(arch, shape):
    jm, m = jbuild(jreg.get_config(arch)), build_model(registry.get_config(arch))
    sh = SHAPES[shape]
    want = jm.input_specs(sh)
    got = m.input_specs(sh)
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), t.dtype) == (tuple(want[k].shape), _dtype(want[k].dtype)), k

    jcache, cache = jm.cache_spec(sh), m.cache_spec(sh)
    assert cache.pos == 0 and jcache["pos"].shape == ()
    layer = 0
    for group in jcache["groups"]:
        flat = jax.tree_util.tree_flatten_with_path(group)[0]
        n = flat[0][1].shape[0] if flat else 0
        for i in range(n):
            got_leaves = {(s, k): t for s, d in cache.layers[layer + i].items()
                          for k, t in d.items()}
            assert len(got_leaves) == len(flat)
            for path, leaf in flat:
                t = got_leaves[(str(path[0].key), str(path[1].key))]
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(leaf.shape[1:]), (layer + i, path)
                assert t.dtype == _dtype(leaf.dtype), (layer + i, path)
        layer += n
    assert layer == len(cache.layers)
