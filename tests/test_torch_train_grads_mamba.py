"""Port parity of ``apply_mamba``'s backward pass across two chunks with
a padded last one (``_chunk_scan``, the carry between chunks, the
identity steps): its input's and every weight's gradient against the
reference's ``jax.vjp`` for one cotangent, op by op (jamba's smoke
sublayer).  The tolerance is ``test_torch_train_grads.py``'s."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import mamba as jm  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import mamba as tm  # noqa: E402
from test_torch_train_grads import GRAD_FLOOR, GRAD_TOL  # noqa: E402


def module_vjp_check(jparams: dict, japply, tmodule, tapply, d: int, s: int) -> None:
    """A sublayer's output (B=2, ``s`` steps, width ``d``, bf16 input)
    pulled back through one seeded cotangent: the input's gradient and
    every weight's, port (``tmodule`` holding ``jparams``) against the
    reference (op by op), each finite and within ``GRAD_TOL`` by the
    relative L2 error of ``test_torch_train_grads.py``."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, s, d)) * 0.5).astype(np.float32)
    w = rng.standard_normal((2, s, d)).astype(np.float32)
    tmodule.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                             for k, v in jax.device_get(jparams).items()})
    tmodule.requires_grad_(True)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tapply(tmodule, xt).float().backward(torch.from_numpy(w))
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda p, x: japply(p, x).astype(jnp.float32), jparams,
                         jnp.asarray(x).astype(jnp.bfloat16))
        gp, gx = vjp(jnp.asarray(w))
    want = {"x": np.asarray(gx.astype(jnp.float32)),
            **{k: np.asarray(v) for k, v in jax.device_get(gp).items()}}
    got = {"x": xt.grad.float(), **{n: p.grad for n, p in tmodule.named_parameters()}}
    assert set(got) == set(want)
    total = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in want.values()))
    for name, ref in want.items():
        g = got[name]
        assert bool(torch.isfinite(g).all()), name
        err = np.linalg.norm(g.numpy() - ref) / max(np.linalg.norm(ref), GRAD_FLOOR * total)
        assert err <= GRAD_TOL, f"{name}: relative L2 error {err}"


def test_apply_mamba_backward_matches_reference():
    jcfg = jreg.get_config("jamba-v0.1-52b", smoke=True)
    tcfg = treg.get_config("jamba-v0.1-52b", smoke=True)
    assert tm.CHUNK == jm.CHUNK
    module_vjp_check(jm.init_mamba(jax.random.PRNGKey(0), jcfg),
                     lambda p, x: jm.apply_mamba(p, jcfg, x)[0], tm.Mamba(tcfg),
                     lambda p, x: tm.apply_mamba(p, tcfg, x), jcfg.d_model, tm.CHUNK + 7)
