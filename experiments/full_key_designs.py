#!/usr/bin/env python3
"""Designs of the full-key device sort, timed on a card at the sizes of
``gensort-skew-valsort.hbm-fullkey``.

    python3 experiments/full_key_designs.py [--seed N] [--reps R] \\
        [--sizes 25,26,27,28] [--designs prefix8,msd,lsd]

Keys are the cell's skewed gensort keys, made on the card as
``perfbench`` makes its pool, sorted with the program's model trained
as the benchmark trains it.  Every design starts from the keys' three
words (``ops.encode_full_keys``, outside the timing):

* ``prefix8``: ``sort_device(model, hi, lo)``, the 8-byte sort alone;
* ``msd`` (the program): ``sort_device(model, hi, lo, tail)``, the
  8-byte sort, then ``learned_sort.order_ties`` re-sorts every record by
  ``(run of equal 8-byte prefixes, tail)``;
* ``lsd``: a stable sort of the tails (as 32-bit keys), then the 8-byte
  ``sort_device`` of the permuted words, the permutations composed.

Each design is timed by CUDA events over ``--reps`` calls after one
warm-up call, with its peak memory above the inputs over one call.  The
answers of ``msd`` and ``lsd`` are held equal at every size, and equal
to the plain reference (``repro_torch.testing.full_key_ref``) at the
smallest.  First, the full-key encode kernel is held bit-equal to its
plain version at the largest size.  One JSON line a design and size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def lsd_sort(model, hi, lo, tail):
    import torch

    from repro_torch.core import learned_sort

    tv, p1 = torch.sort((tail - 2**31).to(torch.int32), stable=True)
    hs, ls, p2 = learned_sort.sort_device(model, hi[p1], lo[p1])
    p2 = p2.to(torch.int64)
    return hs, ls, tv[p2].to(torch.int64) + 2**31, p1[p2].to(torch.int32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2**33 + 7)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sizes", default="25,26,27,28")
    ap.add_argument("--designs", default="prefix8,msd,lsd")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    from perfbench import gensort_keys, harness, manifest
    from repro_torch.core import learned_sort
    from repro_torch.kernels import encode, ops
    from repro_torch.testing import full_key_ref

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = manifest.cell(manifest.load(), "gensort-skew-valsort.hbm-fullkey")
    cfg = cell.config
    sizes = [1 << int(s) for s in args.sizes.split(",")]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    keys_all = gensort_keys.random_records(max(sizes), cfg, gen, dev)
    model, digest = harness.train_model(cfg, dev)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "power": harness._power_limit(), "leaf_sha": digest}), flush=True)

    # the kernel against its plain version, at the largest size, by blocks
    hi, lo, tail = ops.encode_full_keys(keys_all)
    bad = 0
    for b0 in range(0, keys_all.shape[0], 1 << 24):
        want = encode.encode_full_plain(keys_all[b0 : b0 + (1 << 24)])
        bad += sum(int((g[b0 : b0 + (1 << 24)] != w).sum()) for g, w in zip((hi, lo, tail), want))
    print(json.dumps({"encode_full_bit_equal_n": keys_all.shape[0], "words_differing": bad}),
          flush=True)
    del hi, lo, tail

    designs = {
        "prefix8": lambda h, l, t: learned_sort.sort_device(model, h, l),
        "msd": lambda h, l, t: learned_sort.sort_device(model, h, l, t),
        "lsd": lambda h, l, t: lsd_sort(model, h, l, t),
    }
    for n in sizes:
        keys = keys_all[:n]
        words = ops.encode_full_keys(keys)
        answers = {}
        for name in args.designs.split(","):
            fn = designs[name]
            out = fn(*words)  # warm-up
            torch.cuda.synchronize()
            if name != "prefix8":
                answers[name] = [x.cpu() for x in out]
            del out
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            ms = []
            for _ in range(args.reps):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*words)
                e1.record()
                torch.cuda.synchronize()
                ms.append(e0.elapsed_time(e1))
                del out
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
            ms.sort()
            print(json.dumps({"design": name, "n": n, "ms_median": ms[len(ms) // 2],
                              "ms_min": ms[0], "ms_max": ms[-1],
                              "mrec_s": n / ms[len(ms) // 2] / 1e3, "peak_GiB": peak}),
                  flush=True)
        line = {"n": n}
        if len(answers) == 2:
            a, b = answers.values()
            line["msd_equals_lsd"] = all(torch.equal(x, y) for x, y in zip(a, b))
        if n == min(sizes) and "msd" in answers:
            ref = full_key_ref.full_key_sort(keys)
            line["msd_equals_reference"] = all(
                torch.equal(x, y.cpu()) for x, y in zip(answers["msd"], ref))
        print(json.dumps(line), flush=True)
        del words, answers
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
