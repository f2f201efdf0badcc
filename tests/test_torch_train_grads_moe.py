"""Port parity of the backward pass, MoE archs (mixtral, moonshot: the
router, the gather over ``bucket_matrix``, the ``index_add_`` combine
and the ``moe_lb_loss``/``moe_z_loss`` terms): the loss and every
gradient leaf against the reference's ``jax.value_and_grad``, remat
bit-equal, gradients finite.  The checks, tolerances and measured
maxima are ``test_torch_train_grads.py``'s."""

import pytest

pytest.importorskip("torch")

from test_torch_train_grads import (  # noqa: E402
    check_against_reference,
    check_remat,
    grad_case,
)

ARCHS = ["mixtral-8x7b", "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return grad_case(request.param)


def test_loss_and_grads_match_reference(case):
    check_against_reference(case)


def test_remat_grads_are_bit_equal(case):
    check_remat(case)
