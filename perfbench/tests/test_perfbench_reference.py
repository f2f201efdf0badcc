"""The reference check is 0 exactly on the stable sort, and counts every
kind of departure."""

import numpy as np
import pytest
import torch

from perfbench import reference


def _np_stable(keys: np.ndarray) -> np.ndarray:
    k = keys[:, :8].astype(np.uint64)
    v = np.zeros(len(keys), dtype=np.uint64)
    for b in range(8):
        v = v * np.uint64(256) + k[:, b]
    return np.argsort(v, kind="stable")


def _keys(n, seed, alphabet=95):
    rng = np.random.default_rng(seed)
    return rng.integers(32, 32 + alphabet, size=(n, 10), dtype=np.uint8)


@pytest.mark.parametrize("alphabet", [95, 2])
@pytest.mark.parametrize("block", [7, 1 << 24])
def test_stable_sort_matches_numpy_and_checks_clean(alphabet, block):
    keys = torch.from_numpy(_keys(5000, 1, alphabet))
    hi, lo, perm = reference.stable_sort(keys)
    np.testing.assert_array_equal(perm.numpy(), _np_stable(keys.numpy()))
    assert reference.check(keys, hi, lo, perm, block=block) == dict.fromkeys(reference.LIMITS, 0)


def test_hand_made_ties_keep_input_order():
    keys = torch.tensor([list(b"BBBBBBBBxx"), list(b"AAAAAAAAzz"), list(b"BBBBBBBBaa"),
                         list(b"AAAAAAAAaa")], dtype=torch.uint8)
    hi, lo, perm = reference.stable_sort(keys)
    assert perm.tolist() == [1, 3, 0, 2]  # bytes 9-10 are not compared
    swapped = perm[[1, 0, 2, 3]]
    bad = reference.check(keys, hi[[1, 0, 2, 3]], lo[[1, 0, 2, 3]], swapped)
    assert bad == {"perm_bad": 0, "words_bad": 0, "order_bad": 0, "ties_bad": 1}


@pytest.mark.parametrize("block", [5, 1 << 24])
def test_each_departure_is_counted(block):
    keys = torch.from_numpy(_keys(64, 2))
    hi, lo, perm = reference.stable_sort(keys)
    # out of order: swap two neighbours (distinct keys)
    p = perm.clone()
    p[[10, 11]] = p[[11, 10]]
    h, l = reference.encode_words(keys[p.long()])
    assert reference.check(keys, h, l, p, block=block)["order_bad"] == 1
    # a position named twice: perm_bad counts the duplicate and the lost one
    p = perm.clone()
    p[3] = p[4]
    assert reference.check(keys, hi, lo, p, block=block)["perm_bad"] == 2
    # a wrong word
    l2 = lo.clone()
    l2[20] += 1
    assert reference.check(keys, hi, l2, perm, block=block)["words_bad"] == 1
    # a short answer
    bad = reference.check(keys, hi[:32], lo[:32], perm[:32], block=block)
    assert bad["perm_bad"] == 64 and bad["words_bad"] == 64


def test_controls_break_the_order():
    keys = torch.from_numpy(_keys(20_000, 3, alphabet=3))
    for key in ("hi32", "f64"):
        bad = reference.check(keys, *reference.stable_sort(keys, key))
        assert bad["order_bad"] > 0, key
