"""Port parity of the corpus generators: ``repro_torch.data.lines`` must
give the bytes ``repro.data.lines`` gives for the same seed — every
line kind (plain and adversarial), chunked writes with and without the
final newline, the keyed line and fixed-record generators, and
``join_offsets``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import lines as jlines  # noqa: E402
from repro_torch.data import lines as tlines  # noqa: E402


def test_kinds_match():
    assert tlines.KINDS == jlines.KINDS
    assert tlines.ADVERSARIAL_KINDS == jlines.ADVERSARIAL_KINDS
    assert (tlines.KEYED_KEY_BYTES, tlines.KEYED_VALUE_BYTES) == (
        jlines.KEYED_KEY_BYTES, jlines.KEYED_VALUE_BYTES,
    )


@pytest.mark.parametrize("kind", jlines.KINDS)
def test_make_lines_bytes_equal(kind):
    for n, seed, start in ((0, 0, 0), (1, 3, 0), (3_000, 5, 0),
                           (500, 9, 12_345)):
        want = jlines.make_lines(n, kind, seed=seed, start_idx=start)
        got = tlines.make_lines(n, kind, seed=seed, start_idx=start)
        assert got.dtype == want.dtype == np.uint8
        assert got.tobytes() == want.tobytes(), (kind, n, seed, start)


@pytest.mark.parametrize("terminate_last", [True, False])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "reverse", "utf8"])
def test_write_lines_chunked_bytes_equal(tmp_path, kind, terminate_last):
    paths = {}
    for name, mod in (("jax", jlines), ("torch", tlines)):
        paths[name] = str(tmp_path / name)
        mod.write_lines(
            paths[name], 2_500, kind=kind, seed=7, chunk=1_000,
            min_len=2, max_len=40, terminate_last=terminate_last,
        )
    assert open(paths["torch"], "rb").read() == open(paths["jax"], "rb").read()


@pytest.mark.parametrize("gen", ["lines", "records"])
def test_keyed_generators_bytes_equal(tmp_path, gen):
    for key_space, key_offset, seed in ((1, 0, 0), (250, 0, 11),
                                        (4_000, 3_600, 23)):
        make = f"make_keyed_{gen}"
        want = getattr(jlines, make)(
            1_200, key_space=key_space, key_offset=key_offset, seed=seed
        )
        got = getattr(tlines, make)(
            1_200, key_space=key_space, key_offset=key_offset, seed=seed
        )
        assert got.tobytes() == want.tobytes(), (gen, key_space, seed)
        paths = {}
        for name, mod in (("jax", jlines), ("torch", tlines)):
            paths[name] = str(tmp_path / f"{name}_{gen}_{seed}")
            getattr(mod, f"write_keyed_{gen}")(
                paths[name], 1_300, key_space=key_space,
                key_offset=key_offset, seed=seed, chunk=500,
            )
        assert (open(paths["torch"], "rb").read()
                == open(paths["jax"], "rb").read())
    assert tlines.make_keyed_lines(0, key_space=5).size == 0
    with pytest.raises(ValueError, match="key_space"):
        getattr(tlines, f"make_keyed_{gen}")(3, key_space=0)


def test_join_offsets_equal():
    for key_space in (1, 7, 250_000, 625_000):
        for sel in (0.0, 0.1, 0.5, 1.0):
            assert tlines.join_offsets(key_space, sel) == jlines.join_offsets(
                key_space, sel
            )
    with pytest.raises(ValueError, match="selectivity"):
        tlines.join_offsets(10, 1.5)
