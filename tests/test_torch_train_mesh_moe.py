"""The sharded LM step of the MoE arch (mixtral-8x7b's smoke config: 4
experts top-2, sliding window 16) on four gloo CPU ranks, held to the
reference's single-device ``launch.train.train`` from the same numpy
parameters: 8 steps on each of the ``(2, 2)``, ``(4, 1)`` and ``(1, 4)``
meshes, every loss within ``rtol=2e-2`` (the tolerance
``tests/test_torch_train_loop.py`` holds the single-device launcher to),
and step 0's gradients within 0.05 relative L2 of ``jax.grad`` of the
reference's loss, leaf by leaf (measured at most 0.025).
The dispatch runs on every token of the global batch (the reference's
capacity), in ``local_map`` regions on replicated inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jtrain  # noqa: E402
from test_torch_train_mesh import (  # noqa: E402
    GRAD_RTOL, MESHES, grad_errors, reference_grads, run_ranks, sharded_grads)

ARCH = "mixtral-8x7b"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    want = jtrain.train(ARCH, smoke=True, steps=8, batch=4, seq=16, mesh_shape=(1,),
                        log_every=100)
    d = tmp_path_factory.mktemp("moe")
    return want, run_ranks(ARCH, d), d


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_moe_losses_match_reference(runs, shape):
    want, got, _ = runs
    np.testing.assert_allclose(got[str(shape)], want, rtol=2e-2)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_moe_step0_grads_match_reference(runs, shape):
    _, _, d = runs
    err = grad_errors(sharded_grads(d, shape), reference_grads(ARCH))
    assert max(err.values()) < GRAD_RTOL, sorted(err.items(), key=lambda e: -e[1])[:5]
