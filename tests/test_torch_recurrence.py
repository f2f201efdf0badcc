"""``repro_torch.models.recurrence.scan``, the port's ``lax.scan``: a
plain loop on real tensors, one step counted for all of them under the
dry run's ``cost_analysis.CostMode``.

At smoke size (16 tokens) the xlstm train step (autograd, per-layer
remat) and prefill (token by token) on a fake (2, 2) mesh count the
same dot FLOPs and collectives scaled as unrolled, exactly; bytes and
the temp peak agree within ``BAND`` (measured: bytes 0.9916 and 1.0 of
the unrolled count, temp 1.0 and 0.9932: the scaled step leaves out
the gradient additions into the carry of the steps it does not run and
the carries autograd keeps between them).
Outside the mode the scan is the loop the xLSTM code ran before it, bit
for bit, gradients included."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import cost_analysis  # noqa: E402
from repro_torch.models import recurrence, xlstm  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
BAND = 0.02

CELLS = r"""
import json, torch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, mesh as M
from repro_torch.models import recurrence
M.init_fake_process_group(4)
mesh = M.make_device_mesh((2, 2), ("data", "model"), device="cpu")
scan, out = recurrence.scan, {}

def unrolled(*args, **kw):  # recurrence.scan seeing no mode: its plain loop
    outer, recurrence.counter = recurrence.counter, None
    try:
        return scan(*args, **kw)
    finally:
        recurrence.counter = outer

for shape in (ShapeConfig("train_16", "train", 16, 4), ShapeConfig("prefill_16", "prefill", 16, 4)):
    for scale in (True, False):
        recurrence.scan = scan if scale else unrolled
        out[f"{shape.name} {scale}"] = dryrun.run_cell(
            "xlstm-350m", shape.name, "single", smoke=True, mesh=mesh, shape=shape)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def cells():
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", CELLS], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [s for s in out.stdout.splitlines() if s.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("shape", ["train_16", "prefill_16"])
def test_scaled_count_equals_unrolled(cells, shape):
    scaled, unrolled = cells[f"{shape} True"], cells[f"{shape} False"]
    assert scaled["status"] == unrolled["status"] == "ok"
    assert scaled["flops_per_device"] == unrolled["flops_per_device"]
    assert scaled["collectives"] == unrolled["collectives"]
    b = scaled["bytes_accessed_per_device"] / unrolled["bytes_accessed_per_device"]
    t = scaled["memory"]["temp_bytes"] / unrolled["memory"]["temp_bytes"]
    assert abs(b - 1) <= BAND and abs(t - 1) <= BAND, (b, t)


def _old_slstm(p, cfg, x):
    """``apply_slstm`` as it was written before ``recurrence.scan``."""
    xn = xlstm.layers.rms_norm(x, p.norm, cfg.norm_eps)
    b, s = x.shape[0], x.shape[1]
    state = xlstm.init_slstm_cache(cfg, b, x.device)
    hs = []
    for t in range(s):
        state = xlstm._slstm_cell(p, cfg, xn[:, t], state)
        hs.append(state["h"])
    hseq = torch.stack(hs, 1).reshape(b, s, cfg.d_model).to(x.dtype)
    return x + hseq @ p.down.to(x.dtype)


def test_plain_loop_is_bit_equal_with_gradients():
    cfg = registry.get_config("xlstm-350m", smoke=True)
    p = xlstm.SLSTM(cfg, torch.Generator().manual_seed(0))
    for q in p.parameters():
        q.requires_grad_(True)
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16).requires_grad_(True)
    outs = []
    for fn in (xlstm.apply_slstm, _old_slstm):
        y = fn(p, cfg, x)
        grads = torch.autograd.grad(y.float().square().sum(), [x, *p.parameters()])
        outs.append((y, grads))
    (y1, g1), (y2, g2) = outs
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_keepdim_scan_carries_a_dict_in_place():
    """The prefill's form: (B, 1, D) slices, outputs concatenated, the
    carry a dict the step updates."""
    xs = torch.arange(12.0).reshape(1, 4, 3)

    def step(c, xt):
        c["sum"] = c["sum"] + xt
        return c, c["sum"] * 2

    carry, ys = recurrence.scan(step, {"sum": torch.zeros(1, 1, 3)}, xs, keepdim=True)
    assert torch.equal(carry["sum"], xs.sum(1, keepdim=True))
    assert torch.equal(ys, 2 * xs.cumsum(1))


def test_mode_runs_two_steps_for_any_length():
    """Under the mode a 4,096-step scan runs its step twice (the first
    step, then one counted for the other 4,095) and returns the full
    shape."""
    calls = []

    def step(c, xt):
        calls.append(1)
        c = torch.tanh(c @ w + xt)
        return c, c

    w = torch.zeros(8, 8)
    xs = torch.zeros(2, 4096, 8)
    with cost_analysis.CostMode() as mode:
        _, ys = recurrence.scan(step, torch.zeros(2, 8), xs)
    assert len(calls) == 2 and ys.shape == (2, 4096, 8)
    assert mode.cost.dot_flops == 4096 * 2 * 2 * 8 * 8
