"""Port parity of the LM token pipeline: ``SyntheticLM`` and ``BytesLM``
batches and ``length_buckets`` ids from ``repro_torch.data.pipeline`` are
bit-equal to ``repro.data.pipeline``'s — ``length_buckets`` on lengths
drawn as ``tests/test_property.py::test_length_bucketing_monotone`` draws
them (20–400 lengths in 1..10,000, 2–16 buckets) and on skewed samples.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import gensort as jgensort, pipeline as jpipe  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


@pytest.mark.parametrize(
    "vocab,seq_len,batch,seed", [(97, 16, 2, 0), (151_936, 512, 4, 0), (101, 34, 3, 7)]
)
def test_synthetic_lm_equal(vocab, seq_len, batch, seed):
    j = jpipe.SyntheticLM(jpipe.PipelineConfig(vocab, seq_len, batch, seed))
    t = tpipe.SyntheticLM(tpipe.PipelineConfig(vocab, seq_len, batch, seed))
    for step in (0, 1, 17):
        a, b = j.batch_at(step)["tokens"], t.batch_at(step)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(b, a)


def test_bytes_lm_equal(tmp_path):
    path = str(tmp_path / "recs.bin")
    jgensort.write_file(path, 500, seed=3)
    cfg = (97, 64, 4, 1)
    j = jpipe.BytesLM(jpipe.PipelineConfig(*cfg), path)
    t = tpipe.BytesLM(tpipe.PipelineConfig(*cfg), path)
    for step in (0, 5):
        np.testing.assert_array_equal(t.batch_at(step)["tokens"], j.batch_at(step)["tokens"])


def _property_draws(n_cases: int = 15):
    rng = np.random.default_rng(0)
    for _ in range(n_cases):
        n = int(rng.integers(20, 401))
        yield rng.integers(1, 10_001, size=n).astype(np.int64), int(rng.integers(2, 17))


def _skewed_draws():
    rng = np.random.default_rng(1)
    yield np.minimum(rng.zipf(1.5, size=5000), 100_000).astype(np.int64), 16
    yield np.round(rng.lognormal(5.0, 1.5, size=3000)).astype(np.int64) + 1, 8
    yield np.full(200, 512, np.int64), 4  # all equal


@pytest.mark.parametrize(
    "lengths,n_buckets",
    [*_property_draws(), *_skewed_draws()],
    ids=[f"property{i}" for i in range(15)] + ["zipf", "lognormal", "allequal"],
)
def test_length_buckets_equal(lengths, n_buckets):
    got = tpipe.length_buckets(lengths, n_buckets)
    want = jpipe.length_buckets(lengths, n_buckets)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    order = np.argsort(lengths, kind="stable")
    assert (np.diff(got[order]) >= 0).all()
