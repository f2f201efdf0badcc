"""The harness's frozen copy of gensort's key rule keeps the program's
generator's byte range, skew table and log2 rule, and the Sample stage's
stripes.  (The test may import the port; the harness does not.)"""

import json

import numpy as np
import torch

from perfbench import gensort_keys, manifest
from repro_torch.core import format as fmt
from repro_torch.data import gensort

SKEW = json.loads((manifest.HERE / "configs" / "gensort-skew.json").read_text())
UNIFORM = json.loads((manifest.HERE / "configs" / "gensort-uniform.json").read_text())


def test_byte_range_and_key_width():
    for cfg in (SKEW, UNIFORM):
        assert (cfg["ascii_lo"], cfg["ascii_hi"]) == (gensort.ASCII_LO, gensort.ASCII_HI)
        assert (cfg["key_bytes"], cfg["record_bytes"]) == (gensort.KEY_BYTES, gensort.RECORD_BYTES)
    g = torch.Generator().manual_seed(3)
    keys = gensort_keys.random_records(50_000, UNIFORM, g, "cpu")
    assert keys.shape == (50_000, 10) and keys.dtype == torch.uint8
    assert int(keys.min()) == gensort.ASCII_LO and int(keys.max()) == gensort.ASCII_HI


def test_skew_table_is_the_generators():
    assert UNIFORM["skew"] is None
    s = SKEW["skew"]
    assert (s["table_size"], s["table_bytes"]) == (gensort.SKEW_TABLE_SIZE, gensort.SKEW_TABLE_BYTES)
    table = gensort_keys.skew_table(SKEW, "cpu").numpy()
    np.testing.assert_array_equal(table, gensort.skew_table())


def test_log2_rule():
    idx = np.array([0, 1, 2, 3, 4, 7, 8, 1023, 1024, 1025, 2**29 - 1, 2**29, 2**30 - 1,
                    2**40 + 5], dtype=np.int64)
    got = gensort_keys.log2_floor(torch.from_numpy(idx)).numpy()
    want = np.floor(np.log2(np.maximum(idx, 1))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_skewed_prefixes_follow_the_record_index():
    start = 1_000_000
    idx = torch.arange(start, start + 4096)
    keys = gensort_keys.keys_at(idx, SKEW, torch.Generator().manual_seed(1)).numpy()
    want = gensort.skewed_keys(4096, seed=0, start_idx=start)
    np.testing.assert_array_equal(keys[:, :6], want[:, :6])


def test_sample_is_the_sample_stages_stripes(tmp_path):
    n = 200_000
    path = str(tmp_path / "u.bin")
    gensort.write_file(path, n, seed=5)
    cfg = dict(UNIFORM, file_records=n)
    idx = gensort_keys.sample_indices(cfg, "cpu").numpy()
    recs = gensort.read_records(path)
    want = fmt.FixedFormat().sample_keys(path, n, cfg["sample"]["frac"])
    np.testing.assert_array_equal(np.asarray(recs[idx, :10]), want)


def test_full_size_sample_is_ten_million_records():
    idx = gensort_keys.sample_indices(UNIFORM, "meta")
    assert idx.shape[0] == 10_000_000
