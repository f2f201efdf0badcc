"""The port's checkpoint (``repro_torch.train.checkpoint``) and fault
tools (``repro_torch.train.fault``): bit-equal round trips of f32, bf16
and int32 leaves, the reference's on-disk layout, uncommitted steps
ignored, restore onto another device, shape mismatches; the reference's
watchdog, heartbeat and retry checks on the port's copy; and a train
step retried after a failure before its update equals one uninterrupted
step."""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jck  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, SyntheticLM  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.train import checkpoint, fault, train_loop  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "a": torch.randn((3, 4), generator=g),
        "nested": {"b": torch.randn(5, generator=g).to(torch.bfloat16),
                   "c": torch.randn((2, 3), generator=g)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves(tree):
    return dict(checkpoint._flatten(tree))


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 7, tree)
    assert checkpoint.latest_step(d) == 7
    like = {"a": torch.zeros(3, 4), "nested": {"b": torch.zeros(5), "c": torch.zeros(2, 3)},
            "step": torch.tensor(0)}
    back = checkpoint.restore(d, 7, like)
    assert set(_leaves(back)) == set(_leaves(tree))
    for name, want in _leaves(tree).items():
        got = _leaves(back)[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        # bit-equal, NaN patterns and all
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)), name


def test_layout_is_the_reference_s(tmp_path):
    """The same step directory, file names, stored arrays (bf16 as a
    uint16 view) and manifest fields as ``repro.train.checkpoint.save``
    of the same leaves."""
    tree = _tree()
    jtree = {k: (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                 if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
             for k, v in _leaves(tree).items()}
    d_t, d_j = str(tmp_path / "t"), str(tmp_path / "j")
    checkpoint.save(d_t, 3, tree)
    jck.save(d_j, 3, jtree)
    st, sj = os.path.join(d_t, "step_000000003"), os.path.join(d_j, "step_000000003")
    assert sorted(os.listdir(st)) == sorted(os.listdir(sj))
    assert os.listdir(d_t) == ["step_000000003"]
    mt, mj = (json.load(open(os.path.join(s, "manifest.json"))) for s in (st, sj))
    assert mt["step"] == mj["step"] == 3
    # the reference orders leaves by its tree paths; match them by content
    for lt in mt["leaves"]:
        at = np.load(os.path.join(st, lt["file"]))
        hits = [lj for lj in mj["leaves"] if lj["shape"] == lt["shape"]
                and lj["dtype"] == lt["dtype"]
                and np.array_equal(np.load(os.path.join(sj, lj["file"])), at)
                and np.load(os.path.join(sj, lj["file"])).dtype == at.dtype]
        assert len(hits) == 1, lt
    assert np.load(os.path.join(st, mt["leaves"][1]["file"])).dtype == np.uint16


def test_checkpoint_uncommitted_ignored(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save(d, 3, {"x": torch.ones(2)})
    checkpoint.save(d, 5, {"x": torch.ones(2)})
    os.remove(os.path.join(d, "step_000000005", "COMMITTED"))
    assert checkpoint.latest_step(d) == 3
    os.remove(os.path.join(d, "step_000000003", "COMMITTED"))
    assert checkpoint.latest_step(d) is None
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


def test_restore_onto_another_device(tmp_path):
    """Leaves land on ``device``, whatever the device of ``like``'s (here
    a shape-only ``meta`` tree restored to the host, and the host tree
    restored to ``meta``); card ↔ host is ``tests/test_torch_cuda.py``'s."""
    tree = _tree()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 1, tree)
    meta = {k: v.to("meta") if isinstance(v, torch.Tensor) else v for k, v in tree.items()}
    meta["nested"] = {k: v.to("meta") for k, v in tree["nested"].items()}
    back = checkpoint.restore(d, 1, meta, device="cpu")
    for name, want in _leaves(tree).items():
        assert _leaves(back)[name].device.type == "cpu"
        assert torch.equal(_leaves(back)[name], want)
    on_meta = checkpoint.restore(d, 1, tree, device="meta")
    assert all(t.device.type == "meta" for t in _leaves(on_meta).values())


def test_restore_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save(d, 1, {"w": torch.zeros(4, 2)})
    with pytest.raises(ValueError, match="shape mismatch at w"):
        checkpoint.restore(d, 1, {"w": torch.zeros(2, 4)})


def test_overwrite_same_step(tmp_path):
    d = str(tmp_path / "ck")
    checkpoint.save(d, 2, {"w": torch.zeros(3)})
    checkpoint.save(d, 2, {"w": torch.ones(3)})
    assert torch.equal(checkpoint.restore(d, 2, {"w": torch.zeros(3)})["w"], torch.ones(3))


# the reference's fault checks (tests/test_train_substrate.py), on the port


def test_straggler_watchdog():
    w = fault.StragglerWatchdog(threshold=2.0)
    assert not w.observe(0, 1.0)
    assert not w.observe(1, 1.1)
    assert w.observe(2, 5.0)
    assert w.flagged[0][0] == 2


def test_heartbeat_monotonic_clock(tmp_path):
    t = [100.0]
    hb = fault.Heartbeat(str(tmp_path / "hb"), interval_s=30.0, clock=lambda: t[0])
    hb.beat(0)  # first beat always writes
    assert (tmp_path / "hb").read_text().split()[0] == "0"
    t[0] += 29.9
    hb.beat(1)  # under the interval -> suppressed
    assert (tmp_path / "hb").read_text().split()[0] == "0"
    t[0] += 0.1
    hb.beat(2)  # exactly one interval since last write -> fires
    assert (tmp_path / "hb").read_text().split()[0] == "2"
    assert fault.Heartbeat("x").clock is time.monotonic


def test_retry_policy():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("preempted")
        return "ok"

    p = fault.RetryPolicy(max_retries=3, backoff_s=0.01)
    assert p.run(flaky) == "ok"
    assert len(calls) == 3


def test_retry_after_failure_before_update_equals_one_step():
    """A step whose backward raises part-way (after the last layers'
    gradients were kept) is retried by ``RetryPolicy``: parameters,
    optimizer state and metrics equal one uninterrupted step's, bit for
    bit, and the optimizer stepped once."""
    cfg = registry.get_config("qwen3-4b", smoke=True)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(PipelineConfig(
        cfg.vocab_raw, 16, 4)).batch_at(0).items()}
    step = train_loop.build_train_step(model, opt_lib.AdamWConfig(lr=1e-2, warmup_steps=1))

    def run(fail: bool):
        params = model.trainable(model.init_params(0, device="cpu"))
        state = opt_lib.init_state(params)
        first = params.layers[0]["00_attn"].wq
        failed = []

        def boom(grad):
            if fail and not failed:
                failed.append(1)
                raise RuntimeError("preempted in the backward pass")
            return grad

        handle = first.register_hook(boom)
        _, _, metrics = fault.RetryPolicy(backoff_s=0.0).run(
            lambda: step(params, state, batch))
        handle.remove()
        assert len(failed) == fail
        return params, state, metrics

    p1, s1, m1 = run(fail=False)
    p2, s2, m2 = run(fail=True)
    assert int(s2["step"]) == 1
    for (n, a), b in zip(p1.named_parameters(), p2.parameters()):
        assert torch.equal(a, b), n
    for key in ("m", "v"):
        for n in s1[key]:
            assert torch.equal(s1[key][n], s2[key][n]), (key, n)
    assert set(m1) == set(m2)
    for k in m1:
        assert torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m2[k])), k
