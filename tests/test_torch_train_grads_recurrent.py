"""Port parity of the backward pass, the Mamba hybrid (jamba): the loss
and every gradient leaf against the reference's ``jax.value_and_grad``,
remat bit-equal, gradients finite.  The checks, tolerances and measured
maxima are ``test_torch_train_grads.py``'s; ``apply_mamba``'s backward
across chunks is ``test_torch_train_grads_mamba.py``'s."""

import pytest

pytest.importorskip("torch")

from test_torch_train_grads import (  # noqa: E402
    check_against_reference,
    check_remat,
    grad_case,
)


@pytest.fixture(scope="module")
def case():
    return grad_case("jamba-v0.1-52b")


def test_loss_and_grads_match_reference(case):
    check_against_reference(case)


def test_remat_grads_are_bit_equal(case):
    check_remat(case)
