"""Batched serving demo on the PyTorch port: prefill + greedy decode with
KV caches, on a reduced qwen3 config (the same step the dry run traces
at pod scale).  The counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py
    PYTHONPATH=src python examples/torch_serve_lm.py --tiny --device cpu

``--device`` is ``cuda`` (the default; it raises when no card is
present) or ``cpu``; ``--tiny`` serves 2 prompts of 8 tokens for 4 new
in place of 4 x 32 + 24.  It exits non-zero if any logit is not finite;
the last line is one JSON object.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import registry
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ServeEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    batch, prompt, new = (2, 8, 4) if args.tiny else (4, 32, 24)
    cfg = registry.get_config("qwen3-8b", smoke=True)
    model = build_model(cfg)
    engine = ServeEngine(model, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_raw, size=(batch, prompt)).astype(np.int32)

    t0 = time.time()
    out = engine.generate(prompts, max_new_tokens=new)
    dt = time.time() - t0
    finite = engine.stats.logits_finite
    print(f"generated {out.shape[0]}x{out.shape[1]} tokens in {dt:.2f}s "
          f"({out.size / dt:.0f} tok/s incl. warm-up)")
    t0 = time.time()
    out2 = engine.generate(prompts, max_new_tokens=new)
    dt = time.time() - t0
    finite = finite and engine.stats.logits_finite
    print(f"warm: {out2.size / dt:.0f} tok/s")
    print("sample:", out2[0, :12].tolist())
    print(json.dumps({"shape": list(out2.shape), "logits_finite": finite,
                      "repeatable": bool((out == out2).all()), "tokens_per_s": out2.size / dt,
                      "prefill_s": engine.stats.prefill_seconds,
                      "decode_s": engine.stats.decode_seconds}))
    if not finite:
        sys.exit("a logit was not finite")


if __name__ == "__main__":
    main()
