"""End-to-end training script on the PyTorch port: train a
~100M-parameter qwen3-family model for a few hundred steps on the
synthetic pipeline, with checkpointing and resume.  The counterpart of
``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py            # ~100M, 300 steps
    PYTHONPATH=src python examples/torch_train_lm.py --tiny     # seconds-scale
    PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu

``--device`` is ``cuda`` (the default; it raises when no card is
present) or ``cpu``.  Checkpoints go to ``--ckpt-dir`` (or ``CKPT_DIR``;
a fresh temporary directory if neither is given), and a run resumes
from the latest one there.  It exits non-zero unless the loss falls;
the last line is one JSON object.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs.base import ModelConfig
from repro_torch.core.executor import resolve_device
from repro_torch.launch.train import train

# ~100M params: 12L x d768 (GQA 12/4) x ff 2048, 32k vocab
CONFIG_100M = ModelConfig(
    name="qwen3-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=4,
    d_head=64,
    d_ff=2048,
    vocab_raw=32000,
    qk_norm=True,
    rope_theta=10_000.0,
)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=os.environ.get("CKPT_DIR"))
    args = ap.parse_args()
    resolve_device(args.device)  # no card for "cuda": fail before any work
    tiny = args.tiny
    # the optimizer state goes beside the checkpoints, in <ckpt-dir>_opt
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.mkdtemp(prefix="repro_torch_train_lm_"), "ckpt")
    # register the 100M config under qwen3-8b's smoke name
    import repro_torch.configs.qwen3_8b as mod

    orig = mod.SMOKE_CONFIG
    mod.SMOKE_CONFIG = (
        dataclasses.replace(CONFIG_100M, n_layers=2, d_model=128, d_ff=256,
                            n_heads=4, n_kv=2, d_head=32, vocab_raw=1000)
        if tiny
        else CONFIG_100M
    )
    try:
        losses = train(
            "qwen3-8b",
            smoke=True,  # resolves to the config patched above
            steps=20 if tiny else 300,
            batch=4 if tiny else 2,
            seq=64 if tiny else 128,
            ckpt_dir=ckpt_dir,
            ckpt_every=10 if tiny else 100,
            mesh_shape=(1,),
            lr=1e-3,
            log_every=1 if tiny else 10,
            device=args.device,
        )
    finally:
        mod.SMOKE_CONFIG = orig
    print(json.dumps({"steps": len(losses), "first_loss": losses[0], "last_loss": losses[-1],
                      "ckpt_dir": ckpt_dir}))
    if not losses[-1] < losses[0]:
        sys.exit("loss did not improve")
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
