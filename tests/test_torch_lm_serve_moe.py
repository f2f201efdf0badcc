"""Port parity of the LM serving path at smoke size, MoE archs
(mixtral-8x7b, moonshot-v1-16b-a3b: the router, the dispatch over
``bucket_matrix``, the MoE metrics): ``forward``, ``prefill`` and its
cache, teacher-forced ``decode_step``, ``ServeEngine.generate`` and the
converter's round trip against the reference. The checks, tolerances and
token rules are ``test_torch_lm_serve.py``'s."""

import pytest

pytest.importorskip("torch")

from test_torch_lm_serve import (  # noqa: E402
    _case,
    check_forward,
    check_prefill_and_decode,
    check_round_trip,
    check_serve_engine,
)

ARCHS = ["mixtral-8x7b", "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return _case(request.param)


def test_forward_matches_reference(case):
    check_forward(case)


def test_prefill_and_decode_match_reference(case):
    check_prefill_and_decode(case)


def test_serve_engine_matches_reference(case):
    check_serve_engine(case)


def test_from_jax_params_round_trip(case):
    check_round_trip(case)
