"""Port parity of the model configurations: ``repro_torch.configs`` holds
copies of ``repro.configs`` — every arch's ``CONFIG`` and ``SMOKE_CONFIG``
field for field, their ``layer_plan``, ``vocab`` and ``sub_quadratic``,
the ``SHAPES`` table, ``shape_applicable`` and ``registry.all_cells()``.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as jbase, registry as jreg  # noqa: E402
from repro_torch.configs import base as tbase, registry as treg  # noqa: E402

ARCHS = sorted(jreg.ARCHS)


def test_same_archs():
    assert treg.ARCHS.keys() == jreg.ARCHS.keys()
    assert all(v.startswith("repro_torch.configs.") for v in treg.ARCHS.values())


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal(arch, smoke):
    jc, tc = jreg.get_config(arch, smoke), treg.get_config(arch, smoke)
    assert type(tc) is tbase.ModelConfig
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.layer_plan() == jc.layer_plan()
    assert (tc.vocab, tc.sub_quadratic) == (jc.vocab, jc.sub_quadratic)
    for name, shape in tbase.SHAPES.items():
        assert tbase.shape_applicable(tc, shape) == jbase.shape_applicable(
            jc, jbase.SHAPES[name]
        )


def test_shapes_and_cells_equal():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()
    }
    assert treg.all_cells() == jreg.all_cells()
    assert dataclasses.asdict(treg.get_shape("decode_32k")) == dataclasses.asdict(
        jreg.get_shape("decode_32k")
    )
