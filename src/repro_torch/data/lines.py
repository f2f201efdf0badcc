"""Line-corpus generators for the variable-length record format
(core/format.LineFormat; DESIGN.md §8).  A copy of
``src/repro/data/lines.py`` for the PyTorch port: the same seed gives
the same bytes.

The paper benchmarks against GNU coreutils ``sort`` on newline-delimited
ASCII; these generators produce the corpus *shapes* the differential
harness sweeps (tests/test_differential.py):

* ``uniform``     — i.i.d. printable lines, lengths uniform in
  ``[min_len, max_len]``,
* ``skewed``      — gensort ``-s``-style: the first 6 content bytes are
  replaced by a log2-indexed table entry, producing heavy prefix
  duplication (the "spikes" histogram of paper Fig. 3),
* ``dups``        — duplicate-heavy: every line drawn from a small vocab,
  so full-line duplicates dominate and tie-stability is load-bearing,
* ``short``       — lines shorter than any realistic key window (0-6
  content bytes), exercising the zero-padded short-key encoding path,
* ``empty``       — ~30% zero-length lines (bare delimiters) mixed with
  uniform lines.

**Adversarial shapes** (DESIGN.md §11) target exactly the inputs where a
learned CDF degrades and the planner's sample-splitter fallback must
engage — or provably must NOT:

* ``presorted``   — globally ascending 12-digit decimal keys + random
  printable pad: already sorted input (sortedness ~1.0),
* ``reverse``     — the same keys descending: worst-case input order,
* ``zipf``        — TRUE Zipfian key ranks (``rng.zipf``, the "dups"
  kind's squared-uniform pick undersells the tail by orders of
  magnitude): a huge duplicate spike the model cannot split,
* ``allequal``    — every line shares one 16-byte prefix (= the default
  differential key window): key cardinality 1, pure tie-stability,
* ``tiny``        — a 5-key universe: more partitions than distinct keys
  are guaranteed empty,
* ``utf8``        — lines of 2-byte UTF-8 sequences (lead ``0xC2-0xDF``,
  continuation ``0x80-0xBF``): non-ASCII high bytes through the whole
  memcmp path (never collides with the ``\\n`` delimiter).

All generation is vectorized (no per-line Python loop) and a pure
function of ``(kind, n, seed)``; ``write_lines`` streams chunks so
corpora larger than memory are fine, and ``terminate_last=False`` drops
the final newline to exercise the normalization path (GNU sort appends
one; so does LineFormat).

**Keyed / payload corpora** (DESIGN.md §9) feed the merge-free operator
suite (``core/operators.py``): records are ``key value pad`` where the
key is a zero-padded decimal index into a ``key_space``-sized universe
(``dup factor = n / key_space``) and the value is a zero-padded decimal
payload column (the group-by sum target).  ``join_offsets`` derives the
key-universe shift that gives a requested join selectivity between two
corpora; ``write_keyed_records`` is the fixed-layout (gensort-stride)
twin of ``write_keyed_lines``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.gensort import (
    ASCII_HI,
    ASCII_LO,
    KEY_BYTES,
    RECORD_BYTES,
    SKEW_TABLE_SIZE,
    skew_table,
)

ADVERSARIAL_KINDS = (
    "presorted", "reverse", "zipf", "allequal", "tiny", "utf8",
)
KINDS = ("uniform", "skewed", "dups", "short", "empty") + ADVERSARIAL_KINDS

_DELIM = 10  # b"\n"; the printable range [32, 126] never collides
_VOCAB = 64  # distinct lines in the duplicate-heavy corpus
_IDX_DIGITS = 12  # decimal width of presorted/reverse keys
# zipf/tiny keys fill the differential harness's whole 16-byte key
# window: their duplicate structure must survive the key-window cut
# (12 digits + in-window random pad would fake distinct keys)
_DUP_DIGITS = 16
_ZIPF_A = 1.4  # true-Zipf exponent: ~half the mass on the top few ranks
_ZIPF_SPACE = 1_000_000  # zipf rank universe (clip bound)
_TINY_SPACE = 5  # distinct keys in the tiny-universe corpus
# one shared 16-byte prefix = the differential harness's key window, so
# every "allequal" key is identical under LineFormat(max_key_bytes=16)
_ALLEQUAL_PREFIX = np.frombuffer(b"same-key-prefix!", dtype=np.uint8)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def _assemble(lengths: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Pack ``n`` lines of the given *content* lengths (delimiter added)
    into one uint8 buffer of random printable content."""
    lengths = lengths.astype(np.int64)
    if lengths.size == 0:  # empty corpus: a valid zero-line buffer
        return np.empty(0, np.uint8)
    ends = np.cumsum(lengths + 1)
    data = rng.integers(
        ASCII_LO, ASCII_HI + 1, size=int(ends[-1]), dtype=np.uint8
    )
    data[ends - 1] = _DELIM
    return data


def _numbered_lines(
    values: np.ndarray,
    rng: np.random.Generator,
    pad_max: int,
    width: int = _IDX_DIGITS,
) -> np.ndarray:
    """Lines ``<width-digit decimal><random pad>\\n`` for the given key
    values (vectorized; the decimal field decides memcmp order)."""
    from repro_torch.core.encoding import ascii_digits

    n = values.shape[0]
    pads = rng.integers(0, pad_max + 1, size=n).astype(np.int64)
    data = _assemble(width + pads, rng)
    if n == 0:
        return data
    starts = np.concatenate(
        [[0], np.cumsum(width + pads + 1)[:-1]]
    ).astype(np.int64)
    data[starts[:, None] + np.arange(width)] = ascii_digits(values, width)
    return data


def _utf8_lines(n: int, rng: np.random.Generator) -> np.ndarray:
    """Lines of 1..12 two-byte UTF-8 characters: lead ``0xC2-0xDF``,
    continuation ``0x80-0xBF`` — always valid UTF-8, never ``\\n``."""
    if n == 0:
        return np.empty(0, np.uint8)
    chars = rng.integers(1, 13, size=n).astype(np.int64)
    total = int(chars.sum())
    content = np.empty(2 * total, dtype=np.uint8)
    content[0::2] = rng.integers(0xC2, 0xE0, size=total, dtype=np.uint8)
    content[1::2] = rng.integers(0x80, 0xC0, size=total, dtype=np.uint8)
    ends = np.cumsum(2 * chars + 1)
    data = np.empty(int(ends[-1]), dtype=np.uint8)
    mask = np.ones(data.shape[0], dtype=bool)
    mask[ends - 1] = False
    data[mask] = content
    data[ends - 1] = _DELIM
    return data


def make_lines(
    n: int,
    kind: str = "uniform",
    seed: int = 0,
    start_idx: int = 0,
    min_len: int = 1,
    max_len: int = 32,
) -> np.ndarray:
    """One corpus chunk as a uint8 buffer of ``n`` delimiter-terminated
    lines.  ``start_idx`` keeps the skew/key schedule global across
    chunks (presorted/reverse stay globally monotone however the corpus
    is chunked)."""
    if kind not in KINDS:
        raise ValueError(f"unknown line-corpus kind {kind!r}; one of {KINDS}")
    rng = _rng(seed)
    pad_max = max(max_len - _IDX_DIGITS, 0)
    if kind in ("presorted", "reverse"):
        idx = np.arange(start_idx, start_idx + n, dtype=np.int64)
        if kind == "reverse":
            idx = 10**_IDX_DIGITS - 1 - idx
        return _numbered_lines(idx, rng, pad_max=pad_max)
    if kind == "zipf":
        # TRUE Zipf ranks (heavy tail), spread over the digit range by
        # the injective scramble so the spike isn't also a prefix cluster
        ranks = np.minimum(
            rng.zipf(_ZIPF_A, size=n).astype(np.int64), _ZIPF_SPACE
        )
        return _numbered_lines(
            _render_keys(ranks, _DUP_DIGITS), rng,
            max(max_len - _DUP_DIGITS, 0), width=_DUP_DIGITS,
        )
    if kind == "tiny":
        kidx = rng.integers(0, _TINY_SPACE, size=n).astype(np.int64)
        return _numbered_lines(
            _render_keys(kidx, _DUP_DIGITS), rng,
            max(max_len - _DUP_DIGITS, 0), width=_DUP_DIGITS,
        )
    if kind == "allequal":
        w = _ALLEQUAL_PREFIX.shape[0]
        pads = rng.integers(0, max(max_len - w, 0) + 1, size=n)
        data = _assemble(w + pads.astype(np.int64), rng)
        if n:
            starts = np.concatenate(
                [[0], np.cumsum(w + pads + 1)[:-1]]
            ).astype(np.int64)
            data[starts[:, None] + np.arange(w)] = _ALLEQUAL_PREFIX
        return data
    if kind == "utf8":
        return _utf8_lines(n, rng)
    if kind == "dups":
        vocab_len = _rng(seed ^ 0x5EED).integers(
            min_len, max_len + 1, size=_VOCAB
        )
        vocab = [
            _assemble(vocab_len[v : v + 1], _rng((seed << 8) ^ v))
            for v in range(_VOCAB)
        ]
        # zipf-ish pick: squaring the uniform skews mass onto low ids
        pick = (rng.random(n) ** 2 * _VOCAB).astype(np.int64)
        return np.concatenate([vocab[v] for v in pick]) if n else np.empty(
            0, np.uint8
        )
    if kind == "short":
        lengths = rng.integers(0, 7, size=n)
    elif kind == "empty":
        lengths = rng.integers(min_len, max_len + 1, size=n)
        lengths[rng.random(n) < 0.3] = 0
    else:
        lengths = rng.integers(min_len, max_len + 1, size=n)
    data = _assemble(lengths, rng)
    if kind == "skewed" and n:
        # gensort -s transplanted to lines: overwrite the first
        # min(6, len) content bytes with a log2-indexed table entry
        table = skew_table()
        rec_idx = np.maximum(
            np.arange(start_idx, start_idx + n, dtype=np.int64), 1
        )
        tidx = np.floor(np.log2(rec_idx)).astype(np.int64) % SKEW_TABLE_SIZE
        starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
        cols = np.arange(6, dtype=np.int64)
        valid = cols[None, :] < lengths[:, None]
        pos = starts[:, None] + cols[None, :]
        data[pos[valid]] = table[tidx][:, :6][valid]
    return data


def write_lines(
    path: str,
    n: int,
    *,
    kind: str = "uniform",
    seed: int = 0,
    min_len: int = 1,
    max_len: int = 32,
    chunk: int = 500_000,
    terminate_last: bool = True,
) -> None:
    """Stream ``n`` lines of the given shape to ``path`` (chunked;
    supports > memory corpora)."""
    with open(path, "wb") as f:
        done = 0
        while done < n:
            m = min(chunk, n - done)
            buf = make_lines(
                m, kind, seed=seed + done, start_idx=done,
                min_len=min_len, max_len=max_len,
            )
            if not terminate_last and done + m == n and buf.size:
                buf = buf[:-1]  # exercise the unterminated-final-line path
            f.write(buf.tobytes())
            done += m


# ---------------------------------------------------------------------------
# Keyed / payload corpora (operator workloads, DESIGN.md §9)
# ---------------------------------------------------------------------------

KEYED_KEY_BYTES = 12  # decimal key column width of keyed line corpora
KEYED_VALUE_BYTES = 8  # decimal value column width (group-by sum target)

# Key indexes are rendered as ``(idx * _SCRAMBLE) % 10**width``: odd and
# not divisible by 5, so the map is injective mod any 10**width (equal
# keys <=> equal indexes) while spreading small key universes across the
# full digit range — without this, a small universe would only vary in
# its lowest digits, beyond the encoder's 8-byte window, and the CDF
# model would see every key as identical (one giant partition).
_SCRAMBLE = 99_999_989


def _render_keys(kidx: np.ndarray, width: int) -> np.ndarray:
    if kidx.size == 0:
        return kidx.astype(np.int64)
    mx = int(kidx.max())
    if mx >= 10**width:
        raise ValueError(f"key universe exceeds {width} decimal digits")
    if mx > (2**63 - 1) // _SCRAMBLE:
        raise ValueError("key universe too large for int64 scrambling")
    return (kidx * _SCRAMBLE) % (10**width)


def join_offsets(key_space: int, selectivity: float) -> tuple[int, int]:
    """Key-universe offsets ``(left, right)`` whose overlap fraction is
    ``selectivity``: both universes span ``key_space`` keys; the right
    one is shifted so exactly ``round(selectivity * key_space)`` keys
    are shared.  At dup factor >= 1 essentially every universe key
    occurs, so ``selectivity`` is the expected fraction of records with
    a partner."""
    if not 0.0 <= selectivity <= 1.0:
        raise ValueError(f"selectivity must be in [0, 1], got {selectivity}")
    overlap = int(round(selectivity * key_space))
    return 0, key_space - overlap


def _put_digits(
    data: np.ndarray, starts: np.ndarray, values: np.ndarray, width: int,
    at: int,
) -> None:
    """Write zero-padded decimal columns at content offset ``at``."""
    from repro_torch.core.encoding import ascii_digits

    data[starts[:, None] + at + np.arange(width)] = ascii_digits(
        values, width
    )


def make_keyed_lines(
    n: int,
    *,
    key_space: int,
    key_offset: int = 0,
    seed: int = 0,
    key_bytes: int = KEYED_KEY_BYTES,
    value_bytes: int = KEYED_VALUE_BYTES,
    pad_max: int = 12,
) -> np.ndarray:
    """``n`` keyed lines ``<key><value><pad>\\n``: zero-padded decimal
    key drawn uniformly from ``[key_offset, key_offset + key_space)``,
    zero-padded decimal value, then 0..``pad_max`` random printable pad
    bytes (the variable-length tail)."""
    if n == 0:
        return np.empty(0, np.uint8)
    if key_space < 1:
        raise ValueError("key_space must be >= 1")
    rng = _rng(seed)
    kidx = key_offset + rng.integers(0, key_space, size=n, dtype=np.int64)
    keys = _render_keys(kidx, key_bytes)
    vals = rng.integers(
        0, 10 ** min(value_bytes, 18), size=n, dtype=np.int64
    )
    pads = rng.integers(0, pad_max + 1, size=n).astype(np.int64)
    lengths = key_bytes + value_bytes + pads
    data = _assemble(lengths, rng)
    starts = np.concatenate([[0], np.cumsum(lengths + 1)[:-1]])
    _put_digits(data, starts, keys, key_bytes, 0)
    _put_digits(data, starts, vals, value_bytes, key_bytes)
    return data


def write_keyed_lines(
    path: str,
    n: int,
    *,
    key_space: int,
    key_offset: int = 0,
    seed: int = 0,
    key_bytes: int = KEYED_KEY_BYTES,
    value_bytes: int = KEYED_VALUE_BYTES,
    pad_max: int = 12,
    chunk: int = 500_000,
) -> None:
    """Stream ``n`` keyed lines to ``path`` (chunked)."""
    with open(path, "wb") as f:
        done = 0
        while done < n:
            m = min(chunk, n - done)
            f.write(
                make_keyed_lines(
                    m, key_space=key_space, key_offset=key_offset,
                    seed=seed + done, key_bytes=key_bytes,
                    value_bytes=value_bytes, pad_max=pad_max,
                ).tobytes()
            )
            done += m


def make_keyed_records(
    n: int,
    *,
    key_space: int,
    key_offset: int = 0,
    seed: int = 0,
    value_bytes: int = KEYED_VALUE_BYTES,
) -> np.ndarray:
    """Fixed-layout keyed twin: gensort-stride ``(n, 100)`` records whose
    10-byte key is the zero-padded decimal key index and whose payload
    starts with a zero-padded decimal value column."""
    if key_space < 1:
        raise ValueError("key_space must be >= 1")
    rng = _rng(seed)
    rec = rng.integers(
        ASCII_LO, ASCII_HI + 1, size=(n, RECORD_BYTES), dtype=np.uint8
    )
    if n == 0:
        return rec
    kidx = key_offset + rng.integers(0, key_space, size=n, dtype=np.int64)
    keys = _render_keys(kidx, KEY_BYTES)
    vals = rng.integers(
        0, 10 ** min(value_bytes, 18), size=n, dtype=np.int64
    )
    flat = rec.reshape(-1)
    starts = np.arange(n, dtype=np.int64) * RECORD_BYTES
    _put_digits(flat, starts, keys, KEY_BYTES, 0)
    _put_digits(flat, starts, vals, value_bytes, KEY_BYTES)
    return rec


def write_keyed_records(
    path: str,
    n: int,
    *,
    key_space: int,
    key_offset: int = 0,
    seed: int = 0,
    value_bytes: int = KEYED_VALUE_BYTES,
    chunk: int = 500_000,
) -> None:
    """Stream ``n`` keyed fixed-stride records to ``path`` (chunked)."""
    with open(path, "wb") as f:
        done = 0
        while done < n:
            m = min(chunk, n - done)
            f.write(
                make_keyed_records(
                    m, key_space=key_space, key_offset=key_offset,
                    seed=seed + done, value_bytes=value_bytes,
                ).tobytes()
            )
            done += m
