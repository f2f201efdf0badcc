"""Port parity of the leftovers of modules that were otherwise ported:
``repro_torch.data.pipeline.stripe_batches`` against
``repro.data.pipeline.stripe_batches``, the width-1 writer entry point
``repro_torch.core.stages.writer.writer_worker`` against the
reference's, and the names ``repro_torch.core.stages`` exports (the
reference's ``stages/__init__.py`` list, ``LatencyReservoir``,
``ServeStats`` and ``writer_worker`` included).
"""

import queue
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.stages as jstages  # noqa: E402
from repro.core.format import GENSORT as JGENSORT  # noqa: E402
from repro.core.stages import writer as jwriter  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
import repro_torch.core.stages as tstages  # noqa: E402
from repro_torch.core.format import GENSORT  # noqa: E402
from repro_torch.core.format import LineFormat  # noqa: E402
from repro_torch.core.stages import stats as tstats  # noqa: E402
from repro_torch.core.stages import writer as twriter  # noqa: E402
from repro_torch.data import gensort  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402


@pytest.mark.parametrize("n_stripes,batch", [(1, 128), (4, 100), (7, 1_000),
                                             (3, 1)])
def test_stripe_batches_equal_jax(tmp_path, n_stripes, batch):
    path = str(tmp_path / "r.bin")
    gensort.write_file(path, 1_000, seed=3)
    for t, j in zip(tpipeline.record_stripes(1_000, n_stripes),
                    jpipeline.record_stripes(1_000, n_stripes)):
        got = list(tpipeline.stripe_batches(path, t, batch))
        want = list(jpipeline.stripe_batches(path, j, batch))
        assert [o for o, _ in got] == [o for o, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert isinstance(a, np.ndarray) and not isinstance(a, np.memmap)


def _run_writer(worker, fmt, path, blocks, clock):
    write_q = queue.Queue()
    for item in blocks:
        write_q.put(item)
    write_q.put(None)
    errors = []
    worker(clock, path, write_q, 1, threading.Event(), errors)
    return errors


def test_writer_worker_equal_jax(tmp_path):
    """Blocks at their offsets, arriving out of order, on a fresh path:
    the same file as the reference's entry point writes."""
    recs = gensort.make_records(6, seed=1).tobytes()
    r = GENSORT.record_bytes
    outs = {}
    for name, worker, fmt, clock in (
        ("torch", twriter.writer_worker, GENSORT, tstats.PhaseClock()),
        ("jax", jwriter.writer_worker, JGENSORT, jstages.PhaseClock()),
    ):
        blocks = [(4 * r, fmt.parse_blob(recs[4 * r:])),
                  (0, fmt.parse_blob(recs[: 4 * r]))]
        out = tmp_path / f"{name}.bin"
        assert _run_writer(worker, fmt, str(out), blocks, clock) == []
        outs[name] = out.read_bytes()
    assert outs["torch"] == outs["jax"] == recs


def test_writer_worker_reports_a_failure(tmp_path):
    """A path that cannot be opened lands in ``errors`` and sets abort."""
    errors = []
    abort = threading.Event()
    twriter.writer_worker(
        tstats.PhaseClock(), str(tmp_path / "no" / "such" / "dir" / "o.bin"),
        queue.Queue(), 1, abort, errors,
    )
    assert len(errors) == 1 and isinstance(errors[0], OSError)
    assert abort.is_set()


def test_writer_pool_opens_an_existing_file_without_truncating(tmp_path):
    """``create=False``: the distributed sort's ranks other than 0 write
    into the file rank 0 created and preallocated."""
    out = tmp_path / "o.txt"
    out.write_bytes(b"xxxx")
    q = queue.Queue()
    q.put((2, LineFormat().parse_blob(b"b\n")))
    q.put(None)
    errors = []
    pool = twriter.WriterPool(tstats.PhaseClock(), str(out), q, 1,
                              threading.Event(), errors, create=False)
    pool.start()
    pool.join()
    assert errors == [] and out.read_bytes() == b"xxb\n"


def test_stages_exports_equal_jax():
    assert sorted(tstages.__all__) == sorted(jstages.__all__)
    for name in tstages.__all__:
        obj = getattr(tstages, name)
        assert obj.__module__.startswith("repro_torch."), name
        assert obj.__name__ == getattr(jstages, name).__name__
    assert tstages.LatencyReservoir is tstats.LatencyReservoir
    assert tstages.ServeStats is tstats.ServeStats
    assert tstages.writer_worker is twriter.writer_worker
