#!/usr/bin/env python3
"""Drive the PyTorch port's main path, its serving paths, its LM
training path and its examples on one CUDA card and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. build   — compile the encode, RMI, bitonic and histogram kernels from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) and load them;
2. kernels — each kernel against its plain PyTorch version on the card,
   bit for bit, at the shapes the paths give it: encode at
   (1,441,792, 8); RMI at 2**20 buckets with 25,000 and 65,536 leaves on
   uniform and skewed keys, each in generation order and in the main
   path's routed order (two range partitions, each shuffled), and at the
   serving shape (10,000,000 buckets, batches of 64 and 4096 keys);
   bitonic at (8192, 1024) — the batch the
   256 MB default budget produces on a 1 GB file (15 partitions of
   ~667k records, two per batch, padded to 1,441,792 slots) — and over a
   sweep of every width ``learned_sort.plan_batch`` gives, at ~8.4M slots each
   (``BITONIC_SWEEP``), on random, all-equal, SENTINEL-row, presorted
   and reversed rows, each width timed against ``torch.sort``; histogram
   at 1,441,792 ids over 8192, 58,113, the split strategy's top bin
   count (116,224), 464,896 and 2**20 bins, on routed, uniform,
   out-of-range and all-equal ids, with its strategy;
   and the launch floor (a 1-element PyTorch add, timed the same way)
   beside RMI's serving shape and the histogram; the full-key encode on
   ``(n, 10)`` slices of one pool of 10-byte keys at stride 10, as the
   full-key cell reads them (2**25 to 2**28 rows, first rows at every
   offset of a 4-byte word), timed at 2**28 against its bound at 22 B a
   record;
2b. full key — ``ops.encode_full_keys`` then ``learned_sort.sort_device
   (..., tail)``, the full-key cell's call, on 2**22 keys on the card:
   skewed (every call takes the stable fallback) and uniform with 8-byte
   ties of differing tails planted inside one row (the row sorter).
   Launches are counted from 0, each kept and held bit-equal to its
   plain version; the answer equals ``testing.full_key_ref``'s, words
   and permutation, and the full-key counters count the calls;
3. main    — ``repro_torch.core.external.sort_file`` under
   ``SortConfig(manifest=True)`` (device ``cuda``) on a 1 GB skewed
   gensort file (10M records), validated, with every kernel of the sort
   launched, and its manifest loaded back;
4. serve   — ``QueryServer`` under the default ``ServeConfig()`` over
   that file: 4,096 point queries (half hits) and 200 range scans of
   1,000 records, every answer held against a NumPy ``searchsorted``
   oracle, the RMI kernel launched while serving; then 4,096 of the
   points and the ranges through ``QueryEngine`` for its phase seconds, and
   ``repro_torch.launch.query`` end to end at 200,000 records;
5. bytes   — a 1M-record uniform file sorted on the card has the same
   sha256 as the port's host-executor output, through the batched
   executor and through the per-partition device chain
   (``executor="per_partition"``: RMI kernel → bucket grid → row-sort
   kernel a partition; its 10-byte keys ordered whole on the card, by
   their tail words, with no host touch-up), whose row sorter is also
   timed against ``torch.sort`` at the chain's own row shape; and
   ``sort_partition`` on a uniform and a skewed 2**20-record partition
   timed both ways, the whole key on the card against 8 bytes on the
   card and the host's memcmp touch-up, the same bytes either way;
6. cache   — the same file sorted twice on the card under one
   ``ModelCache``: a miss, then a hit, with the same bytes;
7. mergesort — ``mergesort.sort_file`` on that file, the same bytes;
8. ops, lines — the operator cell of ``benchmarks/join_rates.py``: two
   1,000,000-line keyed corpora (key space 250,000, selectivity 0.1)
   co-partition-sorted on the card under a 64 MB budget, joined with the
   boundary check through one RMI kernel launch, and a dup-16 corpus
   deduplicated with counts and grouped by sum; every sorted run and
   output has the bytes of the same steps sorted by the host executor,
   and each output's manifest the model hash of its inputs;
9. ops, fixed — two 2,500,000-record keyed gensort-stride files (250 MB
   a side, key space 625,000, selectivity 0.1) co-partition-sorted on
   the card under the default ``SortConfig()`` (bytes equal to the host
   executor's), joined with the kernel boundary check; the output count
   equals a NumPy oracle and its keys are in memcmp order;
10. dist (run right after the main phase, on its file) — the mesh-scale
   sort: (a) ``terasort.sort_file_distributed(executor="batched")`` on
   an NCCL process group of world size 1 over the 1 GB file, its sha256
   equal to the main phase's output; (c) ``distributed.make_sort_fn`` at
   2**20 skewed keys on the same group; then (b) four gloo ranks sharing
   the card, spawned by this script, sorting a 1,000,000-record skewed
   file under the batched and the mesh executors (sha256 equal to the
   host executor's, std/mean of the ranges below 0.35, RMI launched on
   every rank) and running ``make_sort_fn`` at 2**20 keys a rank.  Every
   kernel launch of (a) and (b) — the router's RMI and histogram, the
   final pass's encode, RMI, histogram and row sorter, also where the
   pass then took the stable fallback — is kept as the path made it and
   held bit-equal to its plain version on those inputs, and (a)'s
   final-pass rows are timed.
   Each ``make_sort_fn`` run holds the global order to ``np.lexsort``,
   loses nothing, holds every kernel launch of the run (the route's
   RMI and histogram over 4-5 bins, ``sort_device``'s over the padded
   slots) bit-equal to its plain version, and the RMI kernel to its
   plain version on the words each rank received;
11. lm (run last) — the LM serving path, ``repro_torch.serve.engine
   .ServeEngine`` on the card: (a) qwen3-4b at full width and depth
   (36 layers, d 2560, 32 heads / 8 kv, vocab 151,936; 4,411,424,256
   seeded f32 parameters) serves 4 ``SyntheticLM`` prompts of 512
   tokens for 32 new; (b) mixtral-8x7b at full width, 2 of its 32
   layers (3,164,688,384 parameters), serves one prompt of 4,608 tokens
   (the chunked attention; not a multiple of the 4,096 window, so the
   ring is rotated) for 512 new, past the window, with capacity factor
   n_experts / top_k so that no MoE token is dropped (the default 1.25's
   drop fraction on the prompt is logged).  Each is held against the
   port's ``forward`` over prompt + generated tokens (``lm_check``):
   each generated token the served logits' argmax; finite logits;
   served logits within 0.3 (36 layers) / 0.1 (2 layers) of forward's at
   every position, with any served MoE route that differs from
   forward's (which must sit at a router near-tie) given forward's
   experts for the comparison; and each generated token equal to
   forward's argmax wherever its top-2 gap exceeds twice that, before
   the first route difference; prefill and decode times, tokens/s, peak
   memory and the device trace are logged.  (d) jamba-v0.1-52b at full width (d 4096, 32
   heads / 8 kv, d_inner 8192, d_state 16, 16 experts top-2, vocab
   65,536), one period of its 32 layers (1 attention, 7 Mamba, 4 MoE;
   13,295,235,072 parameters), serves one prompt of 2,600 tokens (the
   chunked attention; a padded last Mamba chunk) for 64 new at capacity
   factor n_experts / top_k (the default's drop fraction logged); (e)
   xlstm-350m at full size (24 mLSTM/sLSTM layers, 405,431,392
   parameters) serves 4 x 256 + 32, its prefill stepping the recurrence
   token by token; (f) whisper-medium at full size (24 encoder and 24
   decoder layers, 1,012,353,024 parameters) serves 4 requests of 1,500
   seeded stub frames and a 16-token prompt for 224 new, the encoder
   timed apart.  Each is held against the port's own forward (whisper's:
   encoder, cross K/V, decoder) in the same way, within 0.2 (jamba),
   0.45 (xlstm: also recurrent vs parallel mLSTM) and 0.25 (whisper).
   (c) All ten archs at smoke size on the card against the host with
   the same parameters: forward and prefill logits within 5e-2 (the CPU
   tests' tolerance), served tokens under the token rule,
   ``bucket_matrix`` on the MoE archs' expert ids bit for bit.  While
   serving, the encode, RMI and row-sort kernels launch 0 times, and the
   histogram kernel once a MoE dispatch on the card (the dispatch's
   count, ``partition.bucket_matrix``), each launch held bit-equal to
   its plain version on the ids it was given.  Phase 11 runs under
   ``torch.inference_mode()``: serving records no autograd graph;
12. train (after phase 11) — the LM training path,
   ``repro_torch.train.train_loop.build_train_step`` (the launcher's
   step: AdamW in place, per-layer remat, bf16 gradients) on the card:
   (a) qwen3-4b at full width and depth trains 6 steps on one repeated
   ``SyntheticLM`` batch of 2 x 1,024 tokens (the dense attention's
   backward); (b) mixtral-8x7b at full width, 2 of its 32 layers, 4
   steps on 1 x 4,608 tokens at the default capacity factor 1.25 (the
   blockwise attention's backward, a ragged last block, the 4,096
   window; ``moe_dropped_frac`` logged); (d) xlstm-350m at full width
   and depth (405,431,392 parameters), 3 steps on one repeated batch of
   2 x 512 tokens (the sLSTM loop's backward through
   ``models/recurrence.scan``, the parallel mLSTM's (B, S, S) decay
   matrix; cut from 2 x 1,024, where a step took 83.8 s, and traced over
   its last step alone); (e) whisper-medium at full width and depth (24 encoder and
   24 decoder layers, 1,012,353,024 parameters), 3 steps on 2 x (1,500
   seeded stub frames, 1,024 tokens) (the encoder's and the
   cross-attention's backward).  Each: every loss, norm and parameter
   finite, ``grad_norm`` > 0, step 0's ``loss_total`` within 5e-2 of
   ``loss_fn`` under ``inference_mode``, the last loss below the first;
   ms a step, tokens/s, peak memory and the device trace logged; each
   model freed before the next.
   (c) The ten archs at smoke size on the card against the host with
   the same parameters: bf16 gradients within 0.05 relative L2 a leaf,
   one step's loss within 5e-2 and update within the reference's
   microbatch check (dd < 0.35 d1), also at microbatches=2 on yi-9b;
   ``launch.train.train`` on the card stopped and resumed from its
   checkpoint replays the uninterrupted losses within 2e-2.  While
   training, the encode, RMI and row-sort kernels launch 0 times, and the
   histogram kernel once a MoE dispatch on the card (forward and remat
   recompute), each launch held as in phase 11 (``launches_train``).
13. mesh (after phase 12) — the sharded LM step (``sharding/spmd.py``:
   DTensor parameters, optimizer state and batch laid out by
   ``sharding.rules``): (a) qwen3-4b at full width and depth
   (4,411,424,256 parameters), 4 AdamW steps on one repeated
   ``SyntheticLM`` batch of 2 x 1,024 tokens on a (1, 1) ("data",
   "model") DTensor mesh over NCCL, spawned by the script
   (``chip_smoke.mesh_rank``), held against the plain single-rank step
   on the card from the same parameters: every ``loss_total`` within
   1e-2, step 0's update within the reference's microbatch check (dd <
   0.35 d1) on four leaves; ms a step, tokens/s, peak memory and one
   step's collectives by kind logged.  On a (1, 1) mesh every batch
   placement is ``Replicate`` (``spmd.batch_placements``: a mesh axis of
   size 1 never shards a batch).  Then, on the same mesh, one sequence
   served: a prefill of 24 tokens and 4 teacher-forced decode steps of
   full-size qwen3-4b, its logits within 0.3 (phase 11's bound for
   qwen3-4b) of the plain path's on the same parameters.  (Several gloo
   ranks sharing the card cannot carry DTensor — its functional
   all-gather ends the process, ``experiments/gloo_cuda_probe.py`` — and
   NCCL puts no two ranks on one card; the CPU tests hold the multi-rank
   step.)  (b)
   ``launch.train.train`` at smoke size on that mesh, stopped at step 2
   with a checkpoint, resumed on it and on one rank (no process group):
   the uninterrupted losses within 2e-2.  (c) ``launch.dryrun`` of
   qwen3-4b ``train_4k``, mixtral-8x7b ``decode_32k`` and xlstm-350m
   ``train_4k`` (its recurrence counted one step for all) on the 16 x 16
   fake mesh, each in a subprocess on the host's cores, started before
   phase 12 and read here, its record and seconds logged.  (d) The four
   sorter kernels launch 0 times in this phase: ``launches_mesh`` sums
   the counts each rank reads over its own (a) and (b); this process's
   (the plain reference step, the one-rank resume) must be 0 too.
14. examples (after phase 13) — each ``examples/torch_*.py`` run as a
   user runs it, in a subprocess with ``--device cuda``, the four at
   once: the quickstart at 500,000 skewed records with 2 readers (its
   output validated and equal byte for byte to the host executor's
   sort of the same input,
   the encode, RMI and row-sort kernels launched on its path:
   ``launches_quickstart``); the distributed demo at 2**18 records over
   four gloo ranks sharing the card (phase 10's transport; the global
   order ``np.lexsort``'s, nothing lost, RMI launched on every rank);
   serving (finite logits, the same tokens twice) and training at
   ``--tiny`` (the loss falls).  A failing example fails the run.

It then prints one JSON line describing each kernel (the LM phases'
launches under ``launches_lm``, ``launches_train`` and ``launches_mesh``,
the quickstart's under ``launches_quickstart``, the full-key phase's
under ``launches_full_key``) (times from CUDA
events, bounds from the bytes each call must move at 3.35 TB/s or its
operations at 67 TFLOP/s), the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside it, it exits non-zero and prints no
result.
"""

import asyncio
import contextlib
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
MAIN_RECORDS = 10_000_000
BATCH = 1_441_792  # pad_target of two ~667k-record partitions
IDENTITY_RECORDS = 1_000_000
# one power-of-two partition: the per-partition chain pads nothing
POW2_RECORDS = 1 << 20
# the full-key cell's call sizes (its pool's (n, 10) slices), and the
# keys the full-key phase sorts on the card
FULL_KEY_ROWS = (1 << 25, 1 << 26, 1 << 27, 1 << 28)
FULL_KEY_RECORDS = 1 << 22
# kernel results -> the launch count (KERNEL_WRAPPERS name) each reads
RESULT_WRAPPERS = (("encode", "encode_keys"), ("rmi_bucket", "rmi_bucket"),
                   ("sort_rows", "sort_rows"), ("histogram", "bucket_histogram"),
                   ("encode_full", "encode_full_keys"))
# the grid's rows per batch; one bin past a block's shared memory (the
# split strategy); 8 blocks' shared memory (global); learned_sort.Q_RES
# (the split strategy's top bin count, read from the device, is added)
HIST_BINS = (8192, 58_113, 464_896, 1 << 20)
HALF = 666_896  # records of the batch's first partition
# 4,096 points (four waves of 1,024), not 10,000: each hit costs 24-38 ms
# of host time (this script, beside an H100 80GB HBM3 at 700 W), because a
# 1 GB file's ~67 MB partitions exceed the default 64 MB block cache, whose
# bypass copies the whole partition per fetch; at 10,000 the serve phase
# took 264 s of a whole run of 1,144 s on a slower host, too near the
# script's 1,200 s once phase 12 trained xlstm and whisper at full size
SERVE_POINTS, SERVE_RANGES, RANGE_RECORDS = 4096, 200, 1_000
ENGINE_POINTS = 4096
QUERY_RECORDS = 200_000
# the operator cell of benchmarks/join_rates.py (its defaults: 1M lines a
# side, JOIN_DUP = 4, a 64 MB budget; dedup/groupby on its dup-16 corpus)
OPS_LINES, OPS_DUP, OPS_BUDGET = 1_000_000, 16, 64 << 20
# a 500 MB join: 2.5M gensort-stride records a side
OPS_FIXED = 2_500_000
OPS_SELECTIVITY = 0.1
# row widths learned_sort.plan_batch gives: 512-1024 below 4.2M slots,
# 2048-4096 above, 8-256 for small batches of many segments; and the
# widest row
BITONIC_SWEEP = ((16384, 512), (8192, 1024), (4096, 2048), (2048, 4096),
                 (1_048_576, 8), (2, 16384))
# the distributed phase: gloo ranks sharing the card, their file, and the
# keys a rank that make_sort_fn sorts
DIST_RANKS, DIST_RECORDS, SORT_FN_KEYS = 4, 1_000_000, 1 << 20
DIST_TIMEOUT_S = 300
# the LM phase: (a) qwen3-4b at full size serves 4 prompts of 512 tokens
# for 32 new; (b) mixtral-8x7b at full width, 2 of its 32 layers, serves
# one prompt of 4,608 tokens (above the chunked-attention threshold, not a
# multiple of the 4,096 window) for 512 new; (c) the ported archs at smoke
# size, card against host.  Float tolerance and token margin are the CPU
# tests' (tests/test_torch_lm_serve.py).
LM_PROMPTS, LM_PROMPT_LEN, LM_NEW = 4, 512, 32
LM_LONG_PROMPT, LM_LONG_NEW, LM_MIXTRAL_LAYERS = 4608, 512, 2
LM_TOL = 5e-2
LM_TOKEN_MARGIN = 2 * LM_TOL
# served logits (single-token products) against forward's (batched ones)
# differ by bf16 rounding that grows with depth: measured on an H100 80GB
# HBM3 at 700 W 0.2354 at 36 layers (qwen3-4b) and 0.0964 at 2 layers of
# width 4096 (mixtral, every position, near-tie routes aligned), bounded
# here by 0.3 and 0.1; with `python3 experiments/lm_paths.py d e f
# --measure`, 0.1643 on jamba's period, 0.3579 on xlstm's 24 layers (also
# recurrent vs parallel mLSTM) and 0.2046 on whisper's 24 decoder layers,
# bounded by 0.2, 0.45 and 0.25.  A served token whose router lands within
# LM_ROUTE_MARGIN of a tie may pick other experts than forward did
# (measured gaps 2e-5 to 5e-3)
LM_TOL_DEEP, LM_TOL_SHALLOW, LM_ROUTE_MARGIN = 0.3, 0.1, 0.01
LM_TOL_JAMBA, LM_TOL_XLSTM, LM_TOL_WHISPER = 0.2, 0.45, 0.25
# (d) jamba-v0.1-52b at full width, one period (8 of 32 layers), serves one
# prompt of 2,600 tokens (above the chunked-attention threshold; ten Mamba
# chunks of 256 and a padded one of 40) for 64 new; (e) xlstm-350m at full
# size serves 4 x 256 + 32 (its prefill steps token by token: 20.7 s at
# 4 x 512 on an H100 80GB HBM3 at 700 W, cut for the script's time limit);
# (f) whisper-medium at full size serves 4 requests of 1,500 stub frames
# and a 16-token prompt for 224 new
LM_JAMBA_LAYERS, LM_JAMBA_PROMPT, LM_JAMBA_NEW = 8, 2600, 64
LM_WHISPER_REQUESTS, LM_WHISPER_PROMPT, LM_WHISPER_NEW = 4, 16, 224
LM_XLSTM_PROMPT = 256
LM_ARCHS = ("qwen3-4b", "qwen3-8b", "yi-9b", "qwen2-72b", "mixtral-8x7b",
            "moonshot-v1-16b-a3b", "internvl2-26b", "jamba-v0.1-52b", "xlstm-350m",
            "whisper-medium")
# the training phase: (a) qwen3-4b at full size, 6 AdamW steps with
# per-layer remat on one repeated batch of 2 x 1,024 tokens (below
# CHUNK_THRESHOLD: the dense attention's backward); (b) mixtral-8x7b, 2 of
# its 32 layers, 4 steps on 1 x 4,608 (the blockwise attention's backward,
# a ragged last block, the 4,096 window) at the default capacity factor;
# (c) the ten archs at smoke size, card against host.  The learning rate
# is AdamWConfig's default, from the first step (warmup 1), decayed over
# the run.  The per-leaf gradient tolerance is the CPU tests'
# (tests/test_torch_train_grads.py); the update's is the reference's
# microbatch check (dd < 0.35 d1), the resumed losses' its resume check.
TRAIN_A_STEPS, TRAIN_A_BATCH, TRAIN_A_SEQ = 6, 2, 1024
TRAIN_B_STEPS, TRAIN_B_SEQ = 4, 4608
# (d) xlstm-350m at full size, 3 steps on 2 x 512 (the sLSTM loop's
# backward through recurrence.scan, the parallel mLSTM's (B, S, S) decay
# matrix), its device trace over the last step alone: at 2 x 1,024 a step
# took 83.8 s (12 sLSTM layers x 1,024 steps of small launches, forward,
# remat recompute and backward; 6 % device busy) and reading a trace of
# all three ~200 s more, on an H100 80GB HBM3 at 700 W; (e) whisper-medium
# at full size, 3 steps on 2 x (1,500 seeded stub frames, 1,024 tokens)
# (the encoder-decoder's cross-attention backward)
TRAIN_D_STEPS, TRAIN_D_BATCH, TRAIN_D_SEQ, TRAIN_D_TRACED = 3, 2, 512, 1
TRAIN_E_STEPS, TRAIN_E_BATCH, TRAIN_E_SEQ = 3, 2, 1024
TRAIN_LR = 3e-4
TRAIN_GRAD_TOL, TRAIN_GRAD_FLOOR, TRAIN_UPDATE_TOL, TRAIN_RESUME_RTOL = 0.05, 1e-3, 0.35, 2e-2
# the examples phase: each examples/torch_*.py as a user runs it, on the
# card: the quickstart at its default 500,000 records with 2 readers, the
# demo at its default 2**18 records over phase 10's transport (gloo ranks
# sharing the card), serving at its default size, training at --tiny
EX_QUICK_RECORDS, EX_QUICK_READERS = 500_000, 2
EX_DEMO_RECORDS, EX_DEMO_RANKS = 1 << 18, DIST_RANKS
EX_TIMEOUT_S = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 20, cold: bool = True) -> float:
    """Median milliseconds of one ``fn()`` on the card, by CUDA events.

    Before each timed launch the card spins for ~1 ms (``_sleep``), so
    the host has enqueued the launch before the start event fires and
    the interval holds device time only.  ``cold``: a 256 MB write
    first evicts the 50 MB L2, so every input comes from device memory
    (the bound's assumption); otherwise inputs stay warm in L2."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def raw_launch(torch, entry, *args):
    """A C entry point called with preallocated tensors and no wrapper
    work, so that a short kernel's time is not the host's; the return
    code is checked once, outside the timed loops."""
    from repro_torch.kernels import build

    lib = build.library()
    fn = getattr(lib, entry)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    build.check(fn(*ptrs, stream), entry)
    return lambda: fn(*ptrs, stream)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> int:
    return max(
        int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        for g, w in zip(got, want)
    )


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def phase_kernels(torch, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np

    from repro_torch.core import encoding, learned_sort, rmi as rmi_lib
    from repro_torch.core.learned_sort import Q_RES
    from repro_torch.data import gensort
    from repro_torch.kernels import bitonic, encode, rmi

    results: dict = {}
    n = BATCH
    keys_np = {
        "uniform": gensort.uniform_keys(n, seed=1),
        "skewed": gensort.skewed_keys(n, seed=1, start_idx=n),
    }

    # -- encode ------------------------------------------------------------
    keys8 = torch.from_numpy(keys_np["skewed"][:, :8].copy()).to(dev)
    got, want = encode.encode_cuda(keys8), encode.encode_plain(keys8)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    require(err == 0, f"encode kernel differs from its plain version by {err}")
    b_ms, b_by = bound(n * (8 + 16), 0)
    launch = raw_launch(torch, "repro_encode", keys8, got[0], got[1], n)
    results["encode"] = dict(
        name="encode", route="cuda", source=encode.SOURCE,
        replaces="src/repro/kernels/encode.py:29",
        max_abs_err=err,
        ms=cuda_ms(torch, launch),
        plain_ms=cuda_ms(torch, lambda: encode.encode_plain(keys8)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    log(f"kernels: encode ({n}, 8) bit-equal; kernel "
        f"{results['encode']['ms']:.4f} ms (warm L2 "
        f"{cuda_ms(torch, launch, cold=False):.4f} ms), plain "
        f"{results['encode']['plain_ms']:.4f} ms, bound {b_ms:.4f} ms")
    results["encode_full"] = encode_full_check(torch, dev)

    # keys as the main path routes them: two range partitions, each in an
    # order of its own
    order = np.concatenate([
        np.random.default_rng(2).permutation(HALF),
        HALF + np.random.default_rng(3).permutation(n - HALF),
    ])
    routed = {}
    for dist, k in keys_np.items():
        kv = np.ascontiguousarray(k).view("S10").reshape(-1)
        routed[dist] = k[np.argsort(kv, kind="stable")][order]

    # -- RMI ---------------------------------------------------------------
    rmi_err, rmi_entry, model_main = 0, None, None
    for n_leaf in (25_000, 65_536):
        for dist in ("uniform", "skewed"):
            # the main path trains n_leaf = sample / 4 leaves
            sample = keys_np[dist][:: max(1, n // (4 * n_leaf))]
            model = rmi_lib.fit(sample, n_leaf=n_leaf).to(dev)
            for key_order, k in (("generation", keys_np[dist]),
                                 ("routed", routed[dist])):
                hi, lo = encode.encode_cuda(
                    torch.from_numpy(k[:, :8].copy()).to(dev)
                )
                got = rmi.rmi_bucket_cuda(model, hi, lo, Q_RES)
                want = rmi.rmi_bucket_plain(model, hi, lo, Q_RES)
                torch.cuda.synchronize()
                err = max_abs_err(torch, [got], [want])
                require(err == 0, f"RMI kernel (L={n_leaf}, {dist}, "
                                  f"{key_order} order) differs by {err}")
                rmi_err = max(rmi_err, err)
                launch = raw_launch(
                    torch, "repro_rmi_bucket", hi, lo, n,
                    int(model.min_hi), int(model.min_lo),
                    float(model.inv_range), float(model.root_slope),
                    float(model.root_intercept), Q_RES,
                    model.kernel_table, n_leaf, got,
                )
                ms = cuda_ms(torch, launch)
                warm = cuda_ms(torch, launch, cold=False)
                plain = cuda_ms(
                    torch,
                    lambda: rmi.rmi_bucket_plain(model, hi, lo, Q_RES),
                    reps=5,
                )
                # kept at n x 20 B + L x 36 B (the split tables' bytes) so
                # that bounds compare across designs; the packed rows are
                # 32 B a leaf
                table_bytes = n_leaf * (5 * 4 + 2 * 8)
                b_ms, b_by = bound(n * (8 + 8 + 4) + table_bytes, 0)
                log(f"kernels: rmi n={n} L={n_leaf} {dist} {key_order} order "
                    f"bit-equal; kernel {ms:.4f} ms (warm L2 {warm:.4f} ms), "
                    f"plain {plain:.4f} ms, bound {b_ms:.4f} ms = "
                    f"{b_ms / ms:.1%} of bound")
                if (n_leaf, dist, key_order) == (25_000, "skewed", "routed"):
                    # the 1 GB main path trains 25,000 leaves on skewed
                    # keys and routes them so
                    model_main = model
                    rmi_entry = dict(
                        name="rmi_bucket", route="cuda", source=rmi.SOURCE,
                        replaces="src/repro/kernels/rmi.py:64",
                        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None,
                    )
    rmi_entry["max_abs_err"] = rmi_err
    results["rmi_bucket"] = rmi_entry

    # -- bitonic: the rows the grid graph builds for a main-path batch ------
    keys_b = torch.from_numpy(routed["skewed"][:, :8].copy()).to(dev)
    seg = torch.from_numpy(
        (np.arange(n) >= HALF).astype(np.int32)
    ).to(dev)
    n_rows, capacity = learned_sort.plan_batch(n, 15)
    require((n_rows, capacity) == (8192, 1024), f"plan {n_rows}x{capacity}")
    alloc = np.ones(2, np.int64) + (n_rows - 2) * np.array([HALF, n - HALF]) // n
    plan = np.zeros(2 * 15, np.int32)
    plan[15:17] = alloc
    plan[1] = alloc[0]
    plan_d = torch.from_numpy(plan).to(dev)
    _, _, hi_m, lo_m, val_m, counts = learned_sort.segmented_grid_rows(
        model_main, keys_b, seg, plan_d[:15], plan_d[15:],
        n_rows=n_rows, capacity=capacity,
    )
    require(int(counts.sum()) == n, "grid rows lost records")
    got = bitonic.sort_rows_cuda(hi_m, lo_m, val_m)
    want = bitonic.sort_rows_plain(hi_m, lo_m, val_m)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    require(err == 0, f"bitonic kernel differs from its plain version by {err}")
    packed = encoding.packed_key(hi_m, lo_m)
    slots = n_rows * capacity
    stages = capacity.bit_length() - 1
    stages = stages * (stages + 1) // 2
    b_ms, b_by = bound(slots * (8 + 8 + 4) * 2, slots // 2 * stages)
    results["sort_rows"] = dict(
        name="sort_rows", route="cuda", source=bitonic.SOURCE,
        replaces="src/repro/kernels/bitonic.py:86",
        max_abs_err=err,
        ms=cuda_ms(torch, raw_launch(
            torch, "repro_sort_rows", hi_m, lo_m, val_m, *got,
            n_rows, capacity, *bitonic.launch_geometry(capacity),
        )),
        plain_ms=cuda_ms(
            torch, lambda: bitonic.sort_rows_plain(hi_m, lo_m, val_m), reps=5
        ),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(
            torch, lambda: torch.sort(packed, dim=1, stable=True), reps=10
        ),
    )
    r = results["sort_rows"]
    log(f"kernels: sort_rows ({n_rows}, {capacity}) bit-equal "
        f"(max row fill {int(counts.max())}); kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, torch.sort {r['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms; {bitonic.launch_geometry(capacity)}, stages "
        f"{bitonic.stage_split(capacity)}")
    bitonic_sweep(torch, dev)

    # -- the launch floor: the least an event-timed launch can show -------
    one = torch.zeros(1, device=dev)
    floor = cuda_ms(torch, lambda: one.add_(1))
    log(f"kernels: launch floor (1-element add_, cold) {floor:.4f} ms")

    # -- RMI at the serving shape: rows of the 10M-record sorted file ------
    for b in (64, 4096):
        hi, lo = encode.encode_cuda(
            torch.from_numpy(keys_np["skewed"][:b, :8].copy()).to(dev)
        )
        got = rmi.rmi_bucket_cuda(model_main, hi, lo, MAIN_RECORDS)
        want = rmi.rmi_bucket_plain(model_main, hi, lo, MAIN_RECORDS)
        torch.cuda.synchronize()
        err = max_abs_err(torch, [got], [want])
        require(err == 0, f"RMI kernel (serving, {b} keys) differs by {err}")
        launch = raw_launch(
            torch, "repro_rmi_bucket", hi, lo, b,
            int(model_main.min_hi), int(model_main.min_lo),
            float(model_main.inv_range), float(model_main.root_slope),
            float(model_main.root_intercept), MAIN_RECORDS,
            model_main.kernel_table, model_main.n_leaf, got,
        )
        # a batch touches at most one 36-byte leaf row a key
        b_ms, _ = bound(b * (8 + 8 + 4) + min(b, model_main.n_leaf) * 36, 0)
        log(f"kernels: rmi serving shape ({b} keys, {MAIN_RECORDS} buckets) "
            f"bit-equal; kernel {cuda_ms(torch, launch):.4f} ms (warm L2 "
            f"{cuda_ms(torch, launch, cold=False):.4f} ms), plain "
            f"{cuda_ms(torch, lambda: rmi.rmi_bucket_plain(model_main, hi, lo, MAIN_RECORDS), reps=5):.4f} ms, "
            f"bound {b_ms:.6f} ms, launch floor {floor:.4f} ms")

    # -- histogram: the routing histogram of a main-path batch -------------
    from repro_torch.kernels import histogram

    hi, lo = encode.encode_cuda(
        torch.from_numpy(keys_np["skewed"][:, :8].copy()).to(dev)
    )
    max_bins = histogram.max_block_bins()
    top = histogram.SPLIT_CLUSTER * max_bins  # the split strategy's top
    log(f"kernels: histogram strategies: shared up to {max_bins} bins (a "
        f"block's shared memory), split over clusters of "
        f"{histogram.SPLIT_CLUSTER} up to {top}, global beyond")
    rng = np.random.default_rng(4)
    hist_err = 0
    for n_bins in sorted({*HIST_BINS, top}):
        uniform = rng.integers(0, n_bins, size=n, dtype=np.int32)
        mixed = uniform.copy()
        bad = rng.choice(n, size=n // 5, replace=False)
        mixed[bad] = rng.choice(
            np.array([-1, -9, n_bins, 2**31 - 1], np.int32), size=bad.size
        )
        cases = {
            # the ids the batch's keys route to at n_bins buckets
            "routed": rmi.rmi_bucket_cuda(model_main, hi, lo, n_bins),
            "uniform": torch.from_numpy(uniform).to(dev),
            "out_of_range": torch.from_numpy(mixed).to(dev),
            "equal": torch.full((n,), n_bins // 3, dtype=torch.int32,
                                device=dev),
        }
        geo = histogram.launch_geometry(n_bins, max_bins)
        for name, ids in cases.items():
            got = histogram.histogram_cuda(ids, n_bins)
            want = histogram.histogram_plain(ids, n_bins)
            keep = (ids >= 0) & (ids < n_bins)
            lib = torch.bincount(ids[keep], minlength=n_bins)
            torch.cuda.synchronize()
            err = max_abs_err(torch, [got], [want])
            require(err == 0, f"histogram kernel ({n_bins} bins, {name}) "
                              f"differs from its plain version by {err}")
            require(torch.equal(lib.to(torch.int32), got),
                    f"torch.bincount disagrees with the kernel ({n_bins} "
                    f"bins, {name})")
            require(int(got.sum()) == int(keep.sum()),
                    f"histogram ({n_bins}, {name}) counted out-of-range ids")
            hist_err = max(hist_err, err)
            out = torch.empty(n_bins, dtype=torch.int32, device=dev)
            ms = cuda_ms(torch, raw_launch(
                torch, "repro_histogram", ids, n, n_bins,
                histogram.STRATEGIES.index(geo.strategy), geo.cluster,
                geo.block_bins, geo.slice, out,
            ))
            b_ms, b_by = bound(n * 4 + n_bins * 4, n)
            line = (f"kernels: histogram ({n}, {n_bins}) {name} bit-equal "
                    f"({geo.strategy}, cluster {geo.cluster}, "
                    f"{geo.block_bins} bins a block); kernel {ms:.4f} ms, "
                    f"bound {b_ms:.4f} ms, launch floor {floor:.4f} ms")
            if name == "routed":
                entry = dict(
                    name="bucket_histogram", route="cuda",
                    source=histogram.SOURCE,
                    replaces="src/repro/kernels/histogram.py:33",
                    ms=ms,
                    plain_ms=cuda_ms(
                        torch,
                        lambda: histogram.histogram_plain(ids, n_bins),
                        reps=10,
                    ),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=cuda_ms(
                        torch,
                        lambda: torch.bincount(ids, minlength=n_bins),
                        reps=10,
                    ),
                )
                line += (f", plain {entry['plain_ms']:.4f} ms, torch.bincount"
                         f" {entry['library_ms']:.4f} ms")
                if n_bins == HIST_BINS[0]:
                    results["histogram"] = entry
            log(line)
    results["histogram"]["max_abs_err"] = hist_err
    return results


def encode_full_check(torch, dev) -> dict:
    """The full-key encode kernel against its plain version, bit for bit,
    on ``(n, 10)`` slices of one pool of 10-byte keys (every byte value)
    at stride 10, as the full-key cell reads them: each of its call sizes
    with the first row at another offset of a 4-byte word; timed at the
    largest, from an unaligned row."""
    from repro_torch.kernels import encode

    n = FULL_KEY_ROWS[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    pool = torch.randint(0, 256, (n + 4, 10), dtype=torch.uint8, device=dev,
                         generator=gen)
    for rows, off in zip(FULL_KEY_ROWS, (1, 2, 3, 0)):
        keys = pool[off : off + rows]
        err = max_abs_err(torch, encode.encode_full_cuda(keys),
                          encode.encode_full_plain(keys))
        require(err == 0, f"full-key encode kernel at ({rows}, 10), row 0 at "
                          f"byte {10 * off}, differs from its plain version by {err}")
    keys = pool[1 : 1 + n]
    words = encode.encode_full_cuda(keys)
    launch = raw_launch(torch, "repro_encode_full", keys, 10, 10, *words, n)
    # least bytes, as encode_full_roofline counts them: the key read and
    # three 4-byte words written
    b_ms, b_by = bound(n * (10 + 12), 0)
    entry = dict(
        name="encode_full", route="cuda", source=encode.SOURCE, replaces=None,
        max_abs_err=0, ms=cuda_ms(torch, launch),
        plain_ms=cuda_ms(torch, lambda: encode.encode_full_plain(keys), reps=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    log(f"kernels: encode_full ({n}, 10) at stride 10 bit-equal, and at "
        f"{FULL_KEY_ROWS[:-1]} rows; kernel {entry['ms']:.4f} ms, plain "
        f"{entry['plain_ms']:.4f} ms, bound {b_ms:.4f} ms = "
        f"{b_ms / entry['ms']:.1%} of bound")
    del pool, keys, words
    torch.cuda.empty_cache()
    return entry


def bitonic_sweep(torch, dev) -> None:
    """The row sorter at every width the main path can produce, ~8.4M
    slots each: bit-equal to its plain version on five kinds of rows,
    and timed cold beside its bound and ``torch.sort``."""
    from repro_torch.core import encoding
    from repro_torch.kernels import bitonic

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for r, c in BITONIC_SWEEP:
        def words(high):
            return torch.randint(0, high, (r, c), device=dev, generator=gen)

        hi, lo = words(1 << 32), words(1 << 32)
        hi[:, ::3] %= 64  # some equal hi words, so lo and val break ties
        val = torch.randint(-(2**31), 2**31 - 1, (r, c), device=dev,
                            generator=gen, dtype=torch.int32)
        sorted_rows = bitonic.sort_rows_plain(hi, lo, val)
        sentinel = [t.clone() for t in (hi, lo, val)]
        sentinel[0][::2] = encoding.SENTINEL
        sentinel[1][::2] = encoding.SENTINEL
        sentinel[2][::2] = 2**31 - 1
        kinds = {
            "random": (hi, lo, val),
            "equal": (torch.full_like(hi, 7), torch.full_like(lo, 11), val),
            "sentinel_rows": tuple(sentinel),
            "presorted": sorted_rows,
            "reversed": tuple(t.flip(1).contiguous() for t in sorted_rows),
        }
        for kind, rows in kinds.items():
            got = bitonic.sort_rows_cuda(*rows)
            want = bitonic.sort_rows_plain(*rows)
            torch.cuda.synchronize()
            err = max_abs_err(torch, got, want)
            require(err == 0, f"bitonic kernel at ({r}, {c}) on {kind} rows "
                              f"differs from its plain version by {err}")
        geo = bitonic.launch_geometry(c)
        ms = cuda_ms(torch, raw_launch(
            torch, "repro_sort_rows", hi, lo, val, *got, r, c, *geo,
        ))
        packed = encoding.packed_key(hi, lo)
        lib_ms = cuda_ms(
            torch, lambda: torch.sort(packed, dim=1, stable=True), reps=10
        )
        stages = (c.bit_length() - 1) * c.bit_length() // 2
        b_ms, b_by = bound(r * c * (8 + 8 + 4) * 2, r * c // 2 * stages)
        log(f"kernels: sort_rows sweep ({r}, {c}) bit-equal on "
            f"{'/'.join(kinds)}; kernel {ms:.4f} ms, torch.sort "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) = "
            f"{b_ms / ms:.1%} of bound; {geo.rows_per_block} rows x "
            f"{geo.threads_per_row} threads x {geo.elems} slots a block, "
            f"stages {bitonic.stage_split(c)}")


def phase_serve(torch, path: str, tmp: str) -> None:
    """Serve the sorted 1 GB file on the card and hold every answer
    against a NumPy oracle over the file's keys."""
    import numpy as np

    from repro_torch.core.config import ServeConfig
    from repro_torch.data import gensort
    from repro_torch.kernels import ops
    from repro_torch.launch import query
    from repro_torch.serve.index import SortedFileIndex
    from repro_torch.serve.query_engine import QueryEngine
    from repro_torch.serve.server import QueryServer

    cfg = ServeConfig()
    index = SortedFileIndex.open(path, device=cfg.device)
    require(index.device.type == "cuda", f"index on {index.device}")
    m = index.manifest
    points, ranges = query.make_workload(
        index, SERVE_POINTS, SERVE_RANGES, RANGE_RECORDS, seed=0
    )
    recs = gensort.read_records(path)
    keys = np.ascontiguousarray(recs[:, : index.key_width]).view("S10")
    keys = keys.reshape(-1)
    q = np.ascontiguousarray(points).view("S10").reshape(-1)
    rows = np.searchsorted(keys, q, side="left")
    found = (rows < index.n) & (keys[np.minimum(rows, index.n - 1)] == q)

    async def drive():
        server = await QueryServer(index, cfg, own_indexes=False).start()
        t0 = time.perf_counter()
        answers, scans = [], []
        # waves of queue_bound requests: admission never sheds
        for i in range(0, len(q), cfg.queue_bound):
            answers += await asyncio.gather(*[
                server.point(k.tobytes()) for k in points[i : i + cfg.queue_bound]
            ])
        for i in range(0, len(ranges), cfg.queue_bound):
            scans += await asyncio.gather(*[
                server.range_scan(lo, hi)
                for lo, hi in ranges[i : i + cfg.queue_bound]
            ])
        wall = time.perf_counter() - t0
        await server.stop()
        return answers, scans, wall, server.stats

    prof = start_device_trace(torch)
    ops.reset_launches()
    answers, scans, wall, sstats = asyncio.run(drive())
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}
    if prof is not None:
        prof.__exit__(None, None, None)
    wrong = [
        i for i, r in enumerate(answers)
        if not r["ok"] or r["found"] != bool(found[i])
        or r["record"] != (recs[rows[i]].tobytes() if found[i] else None)
    ]
    require(not wrong, f"{len(wrong)} point answers differ from the oracle "
                       f"(first {answers[wrong[0]] if wrong else None})")
    spans = [
        (int(np.searchsorted(keys, np.bytes_(lo), side="left")),
         int(np.searchsorted(keys, np.bytes_(hi), side="right")))
        for lo, hi in ranges
    ]
    bad = [
        i for i, (r, (a, b)) in enumerate(zip(scans, spans))
        if not r["ok"] or r["count"] != b - a or r["data"] != recs[a:b].tobytes()
    ]
    require(not bad, f"{len(bad)} range answers differ from the oracle")
    require(launches["rmi_bucket"] > 0, "serving never launched the RMI kernel")
    require(index.observed_err_lo <= m.err_lo
            and index.observed_err_hi <= m.err_hi,
            f"observed error -{index.observed_err_lo}/+"
            f"{index.observed_err_hi} outside the band -{m.err_lo}/+{m.err_hi}")
    n_q = len(answers) + len(scans)
    log(f"serve: QueryServer {len(answers)} points ({int(found.sum())} hits) "
        f"+ {len(scans)} ranges of {RANGE_RECORDS} records, all ok and equal "
        f"to the oracle; {n_q / wall:.1f} q/s over {wall:.3f} s, p50 "
        f"{sstats.latency_ms(50):.3f} ms p99 {sstats.latency_ms(99):.3f} ms, "
        f"{sstats.n_batches} batches (occupancy {sstats.batch_occupancy:.4f}), "
        f"band hits {index.band_hits}, fallbacks {index.fallbacks}, error "
        f"band -{m.err_lo}/+{m.err_hi} (observed -{index.observed_err_lo}/+"
        f"{index.observed_err_hi}), launches {launches}")
    if prof is None:
        log("serve: device busy share not measured")
    else:
        busy, _ = device_time(prof)
        log(f"serve: device busy {busy * 1e3:.3f} ms of {wall:.3f} s wall = "
            f"{busy / wall:.6%} (torch.profiler)")

    # the first ENGINE_POINTS of the workload through the engine, for its
    # predict/search/scan seconds
    with QueryEngine(index) as eng:
        for i in range(0, min(ENGINE_POINTS, len(q)), cfg.max_batch):
            _, r, f = eng.point(points[i : i + cfg.max_batch])
            require((r == rows[i : i + cfg.max_batch]).all()
                    and (f == found[i : i + cfg.max_batch]).all(),
                    "QueryEngine point answers differ from the oracle")
        eng.range(ranges)
    est = eng.stats
    phases = {k: round(v, 4) for k, v in sorted(est.phase_seconds.items())}
    log(f"serve: QueryEngine batches of {cfg.max_batch}: {est.summary()}; "
        f"phase seconds {json.dumps(phases)}")
    index.close()

    # the launcher end to end: sort on the card, then serve
    ops.reset_launches()
    qstats = query.main([
        "--records", str(QUERY_RECORDS), "--skewed", "--points", "2000",
        "--ranges", "20", "--workdir", os.path.join(tmp, "query"),
    ])
    require(qstats.n_point == 2000 and qstats.n_hits >= 1000,
            f"launch.query served {qstats.summary()}")
    require(ops.rmi_bucket.launches > 0 and ops.encode_keys.launches > 0,
            "launch.query did not run the kernels")
    log(f"serve: launch.query {QUERY_RECORDS} records: {qstats.summary()}")


def launch_counts() -> dict:
    from repro_torch.kernels import ops

    return {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}


def phase_full_key(torch, results: dict) -> None:
    """The full-key cell's call, ``ops.encode_full_keys`` then
    ``sort_device(..., tail)``, on keys on the card down each path:
    skewed keys (the spike's 8-byte prefixes outgrow their rows, so the
    stable fallback sorts them), and uniform keys with a run of 8-byte
    ties of differing tails, and equal whole keys inside it, planted in
    one row (the row sorter).  Launches are counted from 0, kept and held
    bit-equal to their plain versions; the answer is the plain
    reference's (``testing.full_key_ref``), and the counters count it."""
    import numpy as np

    from repro_torch.core import learned_sort, rmi
    from repro_torch.data import gensort
    from repro_torch.kernels import ops
    from repro_torch.testing import full_key_ref

    t0 = time.perf_counter()
    n = FULL_KEY_RECORDS
    uniform = gensort.uniform_keys(n, seed=13)
    uniform[1:600:3, :8] = uniform[0, :8]
    uniform[700:720] = uniform[9]
    uniform[700:720, :8] = uniform[0, :8]
    launches_by_path = {}
    for what, keys, path in (
        ("skewed", gensort.skewed_keys(n, seed=12), "fallback"),
        ("uniform, 8-byte ties planted in a row", uniform, "rows"),
    ):
        # the main path's leaves: a quarter of the sample
        model = rmi.fit(keys[:: n // 65536], n_leaf=16_384).to("cuda")
        t = torch.from_numpy(keys).cuda()
        ops.reset_launches()
        with keep_launches() as kept:
            hi, lo, tail = ops.encode_full_keys(t)
            *got, overflow = learned_sort.sort_device(model, hi, lo, tail,
                                                      return_overflow=True)
            torch.cuda.synchronize()
            launches = launch_counts()
        f = learned_sort.sort_device
        require((f.full_key_calls, f.full_key_records) == (1, n),
                f"full key ({what}): counted {f.full_key_calls} calls, "
                f"{f.full_key_records} records")
        require(bool(overflow) == (path == "fallback"),
                f"full key ({what}): overflow {bool(overflow)}, not the {path} path")
        held = hold_kept(torch, kept, f"full key ({what})")
        require_held(held, launches, f"full key ({what})")
        require(launches["encode_full_keys"] == launches["rmi_bucket"] == 1
                and launches["sort_rows"] == (path == "rows")
                and launches["encode_keys"] == 0,
                f"full key ({what}): launches {launches}")
        want = full_key_ref.full_key_sort(t)
        for name, g, w in zip(("hi", "lo", "tail", "perm"), got, want):
            require(torch.equal(g, w), f"full key ({what}): {name} differs "
                                       f"from the plain reference's")
        eight = learned_sort.sort_device(model, hi, lo)[2]
        ties = int((eight != got[3]).sum())
        require(ties > 0, f"full key ({what}): the 8-byte order is already the "
                          f"whole key's")
        launches_by_path[path] = launches
        log(f"full key: {n} {what} keys on the card, the {path} path; words and "
            f"perm == the plain reference's; {ties} records placed otherwise "
            f"than by their first 8 bytes; launches {launches}, each held")
    for key, name in RESULT_WRAPPERS:
        results[key]["launches_full_key"] = {
            path: by_name[name] for path, by_name in launches_by_path.items()
        }
    log(f"full key: phase {time.perf_counter() - t0:.1f} s")


def time_partition_orders(torch, model, block, reps: int = 5) -> tuple:
    """``executor.sort_partition`` of one partition on the card, timed
    (host clock, median of ``reps`` each, taken in turns) both ways: its
    keys ordered whole on the card, and ordered by 8 bytes on the card
    then touched up on the host (the chain's way for wider keys, here by
    lowering ``encoding.FULL_KEY_BYTES`` to 8 for the call).  Returns
    the two medians in seconds; the two outputs must be the same."""
    import numpy as np

    from repro_torch.core import encoding, executor

    dev = torch.device("cuda")
    full_bytes = encoding.FULL_KEY_BYTES
    times: dict = {True: [], False: []}
    outs = {}
    for _ in range(reps):
        for whole in (True, False):
            encoding.FULL_KEY_BYTES = full_bytes if whole else encoding.ENCODED_BYTES
            try:
                t = time.perf_counter()
                outs[whole] = executor.sort_partition(model, block, device=dev)
                times[whole].append(time.perf_counter() - t)
            finally:
                encoding.FULL_KEY_BYTES = full_bytes
    require(np.array_equal(outs[True].data, outs[False].data),
            "sort_partition: the whole key on the card and the host touch-up "
            "give other bytes")
    return statistics.median(times[True]), statistics.median(times[False])


def phase_per_partition(torch, inp: str, refsum: int, want: str,
                        tmp: str) -> None:
    """The per-partition device chain, driven through ``sort_file`` on two
    files: the 1M-record file, whose partitions are padded to a power of
    two with SENTINEL words that overflow the last bucket, so the stable
    fallback writes them (the reference's behaviour); and a 2**20-record
    file in one partition, where the compacted rows are the answer.
    Both write the host executor's bytes.  The run launches the RMI
    kernel once a partition and the row sorter once a partition that did
    not overflow.  Then each kernel is held against its plain version on
    the chain's own model and partitions, kept as the chain ran, and the
    row sorter is timed at the chain's rows."""
    import numpy as np

    from repro_torch.core import (
        encoding, external, learned_sort, partition, validate,
    )
    from repro_torch.core.config import SortConfig
    from repro_torch.data import gensort
    from repro_torch.kernels import bitonic, ops, rmi

    t0 = time.perf_counter()
    pow2 = os.path.join(tmp, "pow2.bin")
    gensort.write_file(pow2, POW2_RECORDS, seed=9)
    pow2_sum = checksum_file(validate, gensort, pow2)
    host = os.path.join(tmp, "pow2.host")
    external.sort_file(pow2, host, config=SortConfig(executor="host"))
    pow2_want = sha256(host)
    os.unlink(host)
    files = (
        ("1M uniform records", inp, IDENTITY_RECORDS, refsum, want, 0),
        (f"{POW2_RECORDS} uniform records in one partition", pow2,
         POW2_RECORDS, pow2_sum, pow2_want, 1),
    )

    # keep each partition's chain inputs as sort_partition passes them
    chain = learned_sort.sort_device
    kept = []

    def keep(model, hi, lo, tail=None, **kw):
        got = chain(model, hi, lo, tail, **kw)
        kept.append((len(runs), model, hi, lo, tail, got[-1]))
        return got

    runs = []
    learned_sort.sort_device = keep
    try:
        prof = start_device_trace(torch)
        ops.reset_launches()
        for what, path, n, checksum, sha_want, parts in files:
            out = os.path.join(tmp, "per_partition.sorted")
            st = external.sort_file(path, out, config=SortConfig(
                executor="per_partition", n_partitions=parts))
            torch.cuda.synchronize()
            require(validate.validate_file(out, checksum, n)["ok"],
                    f"per_partition output of {what} failed validation")
            sha = sha256(out)
            os.unlink(out)
            require(sha == sha_want,
                    f"per_partition bytes of {what} {sha} != host {sha_want}")
            require(st.executor == "per_partition", f"executor {st.executor}")
            runs.append((what, sha, st))
        launches = launch_counts()
    finally:
        learned_sort.sort_device = chain
    walls = sum(st.wall_seconds for _, _, st in runs)
    log_device_time(prof, "bytes: per_partition", walls)
    dispatches = sum(st.device_dispatches for _, _, st in runs)
    fallbacks = sum(st.fallbacks for _, _, st in runs)
    require(runs[1][2].fallbacks < runs[1][2].device_dispatches,
            "the one power-of-two partition took the stable fallback")
    require(launches["rmi_bucket"] == dispatches == len(kept) > 0,
            f"per_partition launched RMI {launches['rmi_bucket']} times "
            f"for {dispatches} dispatches")
    require(launches["sort_rows"] == dispatches - fallbacks > 0,
            f"per_partition launched the row sorter "
            f"{launches['sort_rows']} times for {dispatches - fallbacks} "
            f"partitions that did not overflow")
    for i, (what, sha, st) in enumerate(runs):
        shapes = sorted({
            learned_sort.grid_shape(hi.shape[0])
            for r, _, hi, *_ in kept if r == i
        })
        log(f"bytes: {what}, per_partition on the card == host, sha256 "
            f"{sha}; partitions of {st.partition_counts} records, rows x "
            f"width {shapes}, fallbacks {st.fallbacks} of "
            f"{st.device_dispatches} dispatches, wall {st.wall_seconds:.3f} "
            f"s ({st.rate_mb_s():.1f} MB/s)")
    log(f"bytes: per_partition launches {launches}")
    # 10-byte keys: every partition's tail words went to the card
    require(all(tail is not None for *_, tail, _ in kept),
            "per_partition sorted a partition of 10-byte keys without its "
            "tail words")

    # each kernel against its plain version on the chain's own inputs;
    # the row sorter timed once at each row shape the chain sorted
    timed = set()
    for r, model, hi, lo, _, overflow in kept:
        nb, cap = learned_sort.grid_shape(hi.shape[0])
        ids = rmi.rmi_bucket_cuda(model, hi, lo, nb)
        err = max_abs_err(torch, [ids.cpu()], [rmi.rmi_bucket_plain(
            model.to("cpu"), hi.cpu(), lo.cpu(), nb)])
        require(err == 0, f"RMI kernel on a {hi.shape[0]}-key partition of "
                          f"{runs[r][0]} differs from its plain version by "
                          f"{err}")
        counts = partition.bucket_histogram(ids, nb)
        hi_m, lo_m, val_m = learned_sort.grid_rows(hi, lo, ids, counts, cap)
        got = bitonic.sort_rows_cuda(hi_m, lo_m, val_m)
        err = max_abs_err(torch, got,
                          bitonic.sort_rows_plain(hi_m, lo_m, val_m))
        require(err == 0, f"bitonic kernel at the chain's ({nb}, {cap}) rows "
                          f"differs from its plain version by {err}")
        if (nb, cap) in timed:
            continue
        timed.add((nb, cap))
        geo = bitonic.launch_geometry(cap)
        ms = cuda_ms(torch, raw_launch(
            torch, "repro_sort_rows", hi_m, lo_m, val_m, *got, nb, cap, *geo,
        ))
        packed = encoding.packed_key(hi_m, lo_m)
        lib_ms = cuda_ms(
            torch, lambda: torch.sort(packed, dim=1, stable=True), reps=10
        )
        plain_ms = cuda_ms(
            torch, lambda: bitonic.sort_rows_plain(hi_m, lo_m, val_m), reps=5
        )
        stages = (cap.bit_length() - 1) * cap.bit_length() // 2
        b_ms, b_by = bound(nb * cap * (8 + 8 + 4) * 2, nb * cap // 2 * stages)
        log(f"bytes: per_partition chain rows ({nb}, {cap}) of a "
            f"{hi.shape[0]}-key partition of {runs[r][0]} (max row fill "
            f"{int(counts.max())}, overflow {overflow}): RMI and sort_rows "
            f"bit-equal to their plain versions; sort_rows kernel "
            f"{ms:.4f} ms, torch.sort {lib_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) = "
            f"{b_ms / ms:.1%} of bound; stages {bitonic.stage_split(cap)}")
    log(f"bytes: per_partition chain: RMI and sort_rows bit-equal to their "
        f"plain versions on all {len(kept)} partitions the chain sorted")
    os.unlink(pow2)

    # one partition of 2**20 records sorted both ways: uniform keys, and
    # the skewed file's largest spike (its 8-byte prefixes repeat)
    from repro_torch.core import rmi as rmi_lib
    from repro_torch.core.format import RecordBlock

    for what, skewed in (("uniform", False), ("skewed spike", True)):
        recs = gensort.make_records(POW2_RECORDS, skewed=skewed, seed=10,
                                    start_idx=(1 << 29) if skewed else 0)
        block = RecordBlock(recs.reshape(-1),
                            np.arange(POW2_RECORDS + 1, dtype=np.int64) * 100,
                            recs[:, :10])
        model = rmi_lib.fit(recs[::16, :10], n_leaf=16_384).to("cuda")
        whole, touchup = time_partition_orders(torch, model, block)
        log(f"bytes: sort_partition of {POW2_RECORDS} {what} records: 10-byte "
            f"keys whole on the card {whole * 1e3:.2f} ms, 8 bytes on the card "
            f"+ host touch-up {touchup * 1e3:.2f} ms (median of 5 each, same "
            f"bytes)")
    log(f"bytes: per_partition phase {time.perf_counter() - t0:.1f} s")


def phase_cache(torch, inp: str, want: str, tmp: str) -> None:
    """Two sorts of one file under one ModelCache on the card: the
    second reuses the model, with the same bytes."""
    from repro_torch.core import external
    from repro_torch.core.config import SortConfig
    from repro_torch.core.model_cache import ModelCache
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cache = ModelCache()
    runs = []
    for k in range(2):
        out = os.path.join(tmp, f"cache{k}.sorted")
        ops.reset_launches()
        st = external.sort_file(inp, out,
                                config=SortConfig(model_cache=cache))
        torch.cuda.synchronize()
        launches = launch_counts()
        runs.append((st.model_cache, sha256(out), st.phase_seconds["train"],
                     st.wall_seconds, launches))
        os.unlink(out)
        for name in ("encode_keys", "rmi_bucket", "sort_rows"):
            require(launches[name] > 0, f"cache run {k} never launched {name}")
    require([r[0] for r in runs] == ["miss", "hit"],
            f"model cache outcomes {[r[0] for r in runs]}")
    require(runs[0][1] == runs[1][1] == want,
            f"cache runs wrote other bytes: {[r[1] for r in runs]}")
    log(f"cache: 1M uniform records twice under one ModelCache: "
        f"{runs[0][0]} then {runs[1][0]}, same sha256; train phase "
        f"{runs[0][2]:.4f} s then {runs[1][2]:.4f} s, wall "
        f"{runs[0][3]:.3f} s then {runs[1][3]:.3f} s; launches "
        f"{runs[0][4]} then {runs[1][4]}; phase "
        f"{time.perf_counter() - t0:.1f} s")


def phase_mergesort(inp: str, want: str, tmp: str) -> None:
    from repro_torch.core import mergesort

    t0 = time.perf_counter()
    out = os.path.join(tmp, "mergesort.sorted")
    st = mergesort.sort_file(inp, out, workdir=tmp)
    sha = sha256(out)
    os.unlink(out)
    require(sha == want, f"mergesort bytes {sha} != learned sort {want}")
    phases = {k: round(v, 3) for k, v in st.phase_seconds.items()}
    log(f"mergesort: 1M uniform records, same sha256 as the learned sort; "
        f"phase seconds {json.dumps(phases)}; phase "
        f"{time.perf_counter() - t0:.1f} s")


def _manifest_hash(path: str) -> str:
    from repro_torch.core import manifest

    return manifest.load(manifest.manifest_path(path)).model_hash


def phase_ops_lines(torch, tmp: str) -> None:
    """benchmarks/join_rates.py's cell on the card: co-partitioned sorts,
    join with the kernel boundary check, dedup with counts, group-by
    sum; the bytes of the same steps with the host executor."""
    from repro_torch.core import operators
    from repro_torch.core.config import SortConfig
    from repro_torch.core.format import LineFormat
    from repro_torch.data import lines
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    d = os.path.join(tmp, "ops_lines")
    os.makedirs(d)
    key_space = OPS_LINES // 4  # join_rates.JOIN_DUP
    loff, roff = lines.join_offsets(key_space, OPS_SELECTIVITY)
    a, b, u = (os.path.join(d, f"{x}.txt") for x in "abu")
    lines.write_keyed_lines(a, OPS_LINES, key_space=key_space,
                            key_offset=loff, seed=11)
    lines.write_keyed_lines(b, OPS_LINES, key_space=key_space,
                            key_offset=roff, seed=23)
    lines.write_keyed_lines(u, OPS_LINES, key_space=OPS_LINES // OPS_DUP,
                            seed=31)
    log(f"ops: wrote 3 x {OPS_LINES} keyed lines in "
        f"{time.perf_counter() - t0:.1f} s")
    fmt = LineFormat(max_key_bytes=lines.KEYED_KEY_BYTES)
    shas = {}
    for name, executor in (("card", "auto"), ("host", "host")):
        cfg = SortConfig(fmt=fmt, memory_budget_bytes=OPS_BUDGET,
                         flush_bytes=1 << 20, executor=executor)
        sa, sb, su = (f"{p}.{name}.sorted" for p in (a, b, u))
        ops.reset_launches()
        t1 = time.perf_counter()
        _, st_ab = operators.sort_co_partitioned([a, b], [sa, sb], cfg)
        _, (st_u,) = operators.sort_co_partitioned([u], [su], cfg)
        torch.cuda.synchronize()
        sort_s = time.perf_counter() - t1
        sort_launches = launch_counts()
        if name == "card":
            for k in ("encode_keys", "rmi_bucket", "sort_rows"):
                require(sort_launches[k] > 0,
                        f"co-partitioned line sorts never launched {k}")
        ops.reset_launches()
        join = operators.external_join(
            sa, sb, f"{sa}.join", memory_budget_bytes=OPS_BUDGET,
            verify=True, use_kernels=True,
        )
        verify_launches = launch_counts()
        require(verify_launches["rmi_bucket"] == 1,
                f"the join's verify launched {verify_launches}")
        dedup = operators.external_dedup(
            su, f"{su}.dedup", counts=True, memory_budget_bytes=OPS_BUDGET)
        group = operators.external_groupby(
            su, f"{su}.groupby", agg="sum",
            value_offset=lines.KEYED_KEY_BYTES,
            value_width=lines.KEYED_VALUE_BYTES,
            memory_budget_bytes=OPS_BUDGET)
        paths = (sa, sb, su, f"{sa}.join", f"{su}.dedup", f"{su}.groupby")
        shas[name] = [sha256(p) for p in paths]
        h = [_manifest_hash(p) for p in paths]
        require(h[0] == h[1] == h[3] and h[2] == h[4] == h[5],
                f"an output's manifest model_hash differs from its "
                f"inputs': {h}")
        rates = ", ".join(f"{s.rate_mb_s():.1f}" for s in (*st_ab, st_u))
        log(f"ops: lines, {name} sorts: 3 co-partitioned sorts in "
            f"{sort_s:.3f} s ({rates} MB/s; "
            f"{[len(s.partition_counts) for s in (*st_ab, st_u)]} "
            f"partitions, executors {[s.executor for s in (*st_ab, st_u)]}),"
            f" launches {sort_launches}")
        for st in (join, dedup, group):
            log(f"ops: lines, {name} sorts: {st.op} {st.n_left}"
                + (f" x {st.n_right}" if st.n_right else "")
                + f" -> {st.n_out} records in {st.wall_seconds:.3f} s "
                f"({st.rate_mb_s():.1f} MB/s in, {st.spill_fallbacks} "
                f"spill fallbacks)")
        log(f"ops: lines, {name} sorts: verify launches {verify_launches}")
        for p in paths:
            os.unlink(p)
            os.unlink(p + ".manifest.npz")
    for p in (a, b, u):
        os.unlink(p)
    os.rmdir(d)
    require(shas["card"] == shas["host"],
            f"line operator bytes differ from the host executor's: {shas}")
    log(f"ops: lines, every sorted run and output equal to the host "
        f"executor's; phase {time.perf_counter() - t0:.1f} s")


def phase_ops_fixed(torch, tmp: str) -> None:
    """A 500 MB fixed-format join on the card: co-partitioned sorts at
    the main path's shapes, the kernel boundary check, an output count
    equal to a NumPy oracle and keys in memcmp order."""
    import numpy as np

    from repro_torch.core import operators
    from repro_torch.core.config import SortConfig
    from repro_torch.data import gensort, lines
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    key_space = OPS_FIXED // 4
    loff, roff = lines.join_offsets(key_space, OPS_SELECTIVITY)
    a, b = (os.path.join(tmp, f"fixed_{x}.bin") for x in "ab")
    lines.write_keyed_records(a, OPS_FIXED, key_space=key_space,
                              key_offset=loff, seed=11)
    lines.write_keyed_records(b, OPS_FIXED, key_space=key_space,
                              key_offset=roff, seed=23)
    # the oracle: sum over shared keys of left count x right count
    ua, ca = np.unique(gensort.read_records(a)[:, :10].copy().view("S10"),
                       return_counts=True)
    ub, cb = np.unique(gensort.read_records(b)[:, :10].copy().view("S10"),
                       return_counts=True)
    _, ia, ib = np.intersect1d(ua, ub, assume_unique=True,
                               return_indices=True)
    want_n = int((ca[ia].astype(np.int64) * cb[ib]).sum())
    log(f"ops: fixed, wrote 2 x {OPS_FIXED} keyed records and counted "
        f"{ia.size} shared keys in {time.perf_counter() - t0:.1f} s")
    shas = {}
    for name, executor in (("host", "host"), ("card", "auto")):
        outs = [f"{p}.{name}.sorted" for p in (a, b)]
        prof = start_device_trace(torch) if name == "card" else None
        ops.reset_launches()
        t1 = time.perf_counter()
        _, sts = operators.sort_co_partitioned(
            [a, b], outs, SortConfig(executor=executor))
        torch.cuda.synchronize()
        sort_s = time.perf_counter() - t1
        launches = launch_counts()
        if name == "card":
            log_device_time(prof, "ops: fixed, card sorts", sort_s)
        shas[name] = [sha256(p) for p in outs]
        log(f"ops: fixed, {name} sorts: 2 x {OPS_FIXED} records in "
            f"{sort_s:.3f} s ({', '.join(f'{s.rate_mb_s():.1f}' for s in sts)}"
            f" MB/s; partitions {[s.partition_counts for s in sts]}, "
            f"executor {sts[0].executor}, dispatches "
            f"{[s.device_dispatches for s in sts]}, batch occupancy "
            f"{[round(s.batch_occupancy, 4) for s in sts]}, fallbacks "
            f"{[s.fallbacks for s in sts]}), launches {launches}")
        if name == "host":
            for p in outs:
                os.unlink(p)
                os.unlink(p + ".manifest.npz")
    require(shas["card"] == shas["host"],
            f"fixed co-partitioned sorts differ from the host's: {shas}")
    for k in ("encode_keys", "rmi_bucket", "sort_rows"):
        require(launches[k] > 0, f"fixed co-partitioned sorts never "
                                 f"launched {k}")
    sa, sb = outs
    out = os.path.join(tmp, "fixed.join")
    ops.reset_launches()
    st = operators.external_join(sa, sb, out, verify=True, use_kernels=True)
    verify_launches = launch_counts()
    require(verify_launches["rmi_bucket"] == 1,
            f"the fixed join's verify launched {verify_launches}")
    require(st.n_out == want_n, f"join wrote {st.n_out} records, the "
                                f"oracle counts {want_n}")
    rec = np.fromfile(out, dtype=np.uint8).reshape(st.n_out, -1)
    kv = rec[:, :10].copy().view("S10").reshape(-1)
    require(bool((kv[:-1] <= kv[1:]).all()), "join output out of order")
    require(_manifest_hash(out) == _manifest_hash(sa) == _manifest_hash(sb),
            "fixed join manifest model_hash differs from its inputs'")
    log(f"ops: fixed, {st.op} {st.n_left} x {st.n_right} -> {st.n_out} "
        f"records (= the oracle, memcmp order) of {rec.shape[1]} bytes in "
        f"{st.wall_seconds:.3f} s ({st.rate_mb_s():.1f} MB/s in, "
        f"{st.spill_fallbacks} spill fallbacks) over {st.n_partitions} "
        f"partitions; verify launches {verify_launches}")
    for p in (a, b, sa, sb, out):
        os.unlink(p)
    for p in (sa, sb, out):
        os.unlink(p + ".manifest.npz")
    log(f"ops: fixed, phase {time.perf_counter() - t0:.1f} s")


def sort_fn_check(torch, mesh, n: int) -> dict:
    """``make_sort_fn`` over ``mesh`` at ``n`` skewed keys a rank (every
    rank makes the whole input from one seed and takes its shard): the
    global order against ``np.lexsort``, ``lost``, the launches, every
    kernel launch held bit-equal to its plain version on the inputs the
    path gave it (the route's and ``sort_device``'s), and the RMI kernel
    against its plain version on the words the rank received, captured
    as ``sort_device`` got them."""
    import numpy as np

    from repro_torch.core import distributed, encoding, learned_sort, rmi
    from repro_torch.data import gensort
    from repro_torch.kernels import ops, rmi as krmi

    world, rank = mesh.world_size, mesh.rank
    keys = gensort.skewed_keys(n * world, seed=21)
    model = rmi.fit(keys[:: max(1, keys.shape[0] // 65536)])
    hi, lo = (w.astype(np.int64) for w in encoding.encode_np(keys))
    s = slice(rank * n, (rank + 1) * n)
    args = [torch.from_numpy(a[s]).to(mesh.device) for a in (hi, lo)]
    args.append(torch.arange(n * world, dtype=torch.int32)[s].to(mesh.device))
    chain, kept = learned_sort.sort_device, []

    def keep(model, hi, lo, **kw):
        got = chain(model, hi, lo, return_overflow=True, **kw)
        kept.append((model, hi, lo, got[3]))
        return got[:3]

    learned_sort.sort_device = keep
    try:
        fn = distributed.make_sort_fn(mesh, ("data",), model, n)
        ops.reset_launches()
        with keep_launches() as launched:
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        learned_sort.sort_device = chain
    held = hold_kept(torch, launched, f"(c) rank {rank}")
    require_held(held, launches, f"(c) rank {rank}")
    launched.clear()
    m, rh, rl, overflow = kept[0]
    nb, _ = learned_sort.grid_shape(rh.shape[0])
    err = max_abs_err(torch, [krmi.rmi_bucket_cuda(m, rh, rl, nb).cpu()],
                      [krmi.rmi_bucket_plain(m.to("cpu"), rh.cpu(), rl.cpu(), nb)])
    full = [mesh.all_gather(t) for t in out]
    res = {"seconds": seconds, "launches": launches, "rmi_err": err,
           "held": {k: sorted(set(map(tuple, v))) for k, v in held.items()},
           "fallbacks": int(overflow), "received": rh.shape[0],
           "n_valid": full[3].reshape(-1).tolist(),
           "lost": int(full[4].sum())}
    if rank == 0:
        gh, gl, gv = distributed.global_sorted_from_shards(*full[:4], world)
        o = np.lexsort((lo, hi))
        res["order_ok"] = bool(gh.shape[0] == n * world
                               and (gh == hi[o]).all() and (gl == lo[o]).all()
                               and np.unique(gv).shape[0] == n * world)
    return res


@contextlib.contextmanager
def keep_launches():
    """While active, every launch of the encode, RMI, row-sort,
    histogram and full-key encode kernels keeps what the path gave the
    kernel and what it gave back, as
    ``(entry, args, outputs)`` in the list it yields — including a
    launch whose result the path then threw away for the stable
    fallback."""
    from repro_torch.kernels import bitonic, encode, histogram, rmi

    kept, saved = [], []
    for mod, name in ((encode, "encode_cuda"), (rmi, "rmi_bucket_cuda"),
                      (bitonic, "sort_rows_cuda"),
                      (histogram, "histogram_cuda"),
                      (encode, "encode_full_cuda")):
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def keep(*args, _fn=fn, _name=name):
            out = _fn(*args)
            kept.append((_name, args, out))
            return out

        setattr(mod, name, keep)
    try:
        yield kept
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# kept entry -> the wrapper whose launch count it matches
KEPT_WRAPPER = {"encode_cuda": "encode_keys", "rmi_bucket_cuda": "rmi_bucket",
                "sort_rows_cuda": "sort_rows",
                "histogram_cuda": "bucket_histogram",
                "encode_full_cuda": "encode_full_keys"}


def hold_kept(torch, kept: list, what: str) -> dict:
    """Each kept launch's outputs against its kernel's plain version on
    the same inputs, bit for bit (RMI's plain version on the host, as in
    the other phases).  Returns the shapes held, by wrapper name (the
    histogram's as ``[ids, bins]``)."""
    from repro_torch.kernels import bitonic, encode, histogram, rmi

    plain = {
        "encode_cuda": encode.encode_plain,
        "rmi_bucket_cuda": lambda p, hi, lo, nb: rmi.rmi_bucket_plain(
            p.to("cpu"), hi.cpu(), lo.cpu(), nb),
        "sort_rows_cuda": bitonic.sort_rows_plain,
        "histogram_cuda": lambda ids, nb, *_: histogram.histogram_plain(ids, nb),
        "encode_full_cuda": encode.encode_full_plain,
    }
    held: dict = {}
    for name, args, out in kept:
        got = out if isinstance(out, tuple) else (out,)
        want = plain[name](*args)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(torch, [g.cpu() for g in got],
                          [w.cpu() for w in want])
        shape = list(args[1 if name == "rmi_bucket_cuda" else 0].shape)
        if name == "histogram_cuda":
            shape.append(args[1])
        require(err == 0, f"{what}: {name} at {shape} differs from its "
                          f"plain version by {err}")
        held.setdefault(KEPT_WRAPPER[name], []).append(shape)
    return held


def require_held(held: dict, launches: dict, what: str) -> None:
    """Every launch of the run was kept and held."""
    for name in KEPT_WRAPPER.values():
        require(len(held.get(name, ())) == launches[name],
                f"{what}: held {len(held.get(name, ()))} {name} launches "
                f"of {launches[name]}")


@contextlib.contextmanager
def count_dispatches():
    """While active, counts in the one-element list it yields the MoE
    dispatches on the card (``partition.bucket_matrix`` on CUDA ids):
    on the LM paths each is the histogram kernel's one launch."""
    from repro_torch.core import partition

    fn, n = partition.bucket_matrix, [0]

    def count(ids, *args):
        n[0] += ids.is_cuda
        return fn(ids, *args)

    partition.bucket_matrix = count
    try:
        yield n
    finally:
        partition.bucket_matrix = fn


def require_lm_launches(torch, kept: list, launches: dict, dispatches: int,
                        what: str) -> None:
    """An LM path launches no encode, RMI, row-sort or full-key encode
    kernel, and the histogram kernel once a MoE dispatch, each launch held
    bit-equal to its plain version."""
    sorters = {k: launches[k]
               for k in ("encode_keys", "rmi_bucket", "sort_rows", "encode_full_keys")}
    require(not any(sorters.values()),
            f"{what}: a sorter kernel launched {launches}")
    require(launches["bucket_histogram"] == dispatches,
            f"{what}: {launches['bucket_histogram']} histogram launches for "
            f"{dispatches} MoE dispatches")
    require_held(hold_kept(torch, kept, what), launches, what)


def distributed_rank() -> None:
    """One rank of phase (b)/(c): gloo over ranks sharing ``cuda:0``,
    spawned by ``phase_distributed``; prints one ``RANK`` JSON line."""
    import torch

    from repro_torch.core import terasort
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as tmesh

    env = os.environ
    tmesh.initialize_multiprocess(
        f"file://{env['DIST_STORE']}", int(env["WORLD_SIZE"]),
        int(env["RANK"]), backend="gloo", device="cuda", timeout_s=120,
    )
    mesh = tmesh.make_data_mesh()
    res = {"device": str(mesh.device)}
    for ex in ("batched", "mesh"):
        with keep_launches() as kept:
            ops.reset_launches()
            st = terasort.sort_file_distributed(
                env["DIST_IN"], f"{env['DIST_IN']}.{ex}", mesh, executor=ex,
                workdir=env["DIST_WORK"],
            )
            torch.cuda.synchronize()
            launches = launch_counts()
        held = hold_kept(torch, kept, f"(b) {ex} on rank {mesh.rank}")
        kept.clear()
        res[ex] = {"launches": launches, "wall": st.wall_seconds,
                   "partition_counts": st.partition_counts,
                   "fallbacks": st.fallbacks, "executor": st.executor,
                   "dispatches": st.device_dispatches, "held": held}
    res["sort_fn"] = sort_fn_check(torch, mesh, int(env["SORT_FN_KEYS"]))
    print("RANK " + json.dumps(res), flush=True)
    tmesh.exit_rank()


def phase_distributed(torch, inp: str, refsum: int, want: str, n: int,
                      tmp: str, results: dict) -> None:
    """The mesh-scale sort on the card.  (a) ``sort_file_distributed``
    on NCCL at world size 1 (NCCL puts no two ranks on one card) on the
    main phase's file: its bytes.  (c, 1) ``make_sort_fn`` on the same
    process group.  (b) and (c, 4): ``DIST_RANKS`` gloo ranks sharing
    the card, spawned here: a ``DIST_RECORDS`` skewed file under the
    batched and the mesh executors (host executor's bytes, equi-depth
    ranges, RMI launched on every rank), then ``make_sort_fn``."""
    import numpy as np

    from repro_torch.core import external, terasort, validate
    from repro_torch.core.config import SortConfig
    from repro_torch.data import gensort
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as tmesh

    t0 = time.perf_counter()
    dist_launches = {}
    # (a) NCCL, world size 1, in this process
    tmesh.initialize_multiprocess(
        f"file://{os.path.join(tmp, 'store_a')}", 1, 0, device="cuda",
        timeout_s=120,
    )
    try:
        mesh = tmesh.make_data_mesh()
        require(mesh.backend == "nccl", f"backend {mesh.backend}")
        out = os.path.join(tmp, "dist_a.sorted")
        with keep_launches() as kept:
            ops.reset_launches()
            st = terasort.sort_file_distributed(
                inp, out, mesh, executor="batched", workdir=tmp)
            torch.cuda.synchronize()
            dist_launches["a_nccl_w1_batched"] = launch_counts()
        res = validate.validate_file(out, refsum, n)
        require(res["ok"], f"(a) distributed output failed validation: {res}")
        sha = sha256(out)
        os.unlink(out)
        require(sha == want, f"(a) distributed bytes {sha} != main {want}")
        require(st.executor == "batched", f"(a) executor {st.executor}")
        for name in ("encode_keys", "rmi_bucket", "sort_rows", "bucket_histogram"):
            require(dist_launches["a_nccl_w1_batched"][name] > 0,
                    f"(a) {name} was never launched")
        held = hold_kept(torch, kept, "(a)")
        require_held(held, dist_launches["a_nccl_w1_batched"], "(a)")
        log(f"dist: (a) every kernel launch of the run held bit-equal to "
            f"its plain version on the inputs the path gave it: "
            f"{ {k: sorted(set(map(tuple, v))) for k, v in held.items()} }")
        time_final_rows(torch, kept)
        kept.clear()
        phases = {k: round(v, 3) for k, v in st.phase_seconds.items()}
        log(f"dist: (a) sort_file_distributed NCCL world 1, {n} records, "
            f"batched: sha256 == main, validated; wall {st.wall_seconds:.3f} "
            f"s ({st.rate_mb_s():.1f} MB/s), route capacity retries + "
            f"executor overflows {st.fallbacks}, dispatches "
            f"{st.device_dispatches}, phases "
            f"{json.dumps(phases)}, launches "
            f"{dist_launches['a_nccl_w1_batched']}")
        c1 = sort_fn_check(torch, mesh, SORT_FN_KEYS)
    finally:
        torch.distributed.destroy_process_group()
    dist_launches["c_nccl_w1"] = c1["launches"]
    require(c1["order_ok"] and c1["lost"] == 0 and c1["rmi_err"] == 0
            and c1["launches"]["rmi_bucket"] > 0,
            f"(c) make_sort_fn at world 1: {c1}")
    log(f"dist: (c) make_sort_fn NCCL world 1, {SORT_FN_KEYS} skewed keys: "
        f"order == np.lexsort, lost 0, RMI bit-equal to plain on the "
        f"{c1['received']} received words, sort_device fallbacks "
        f"{c1['fallbacks']} (SENTINEL capacity padding in the last bucket), "
        f"{c1['seconds']:.3f} s, launches {c1['launches']}, each held "
        f"bit-equal to its plain version: {c1['held']}")

    # (b), (c) gloo ranks sharing the card
    path = os.path.join(tmp, "dist_b.bin")
    gensort.write_file(path, DIST_RECORDS, skewed=True, seed=5)
    host = path + ".host"
    external.sort_file(path, host, config=SortConfig(executor="host"))
    host_sha = sha256(host)
    os.unlink(host)
    work = os.path.join(tmp, "dist_work")
    os.makedirs(work, exist_ok=True)
    t1 = time.perf_counter()
    outs = tmesh.spawn(
        "import chip_smoke; chip_smoke.distributed_rank()",
        DIST_RANKS, timeout_s=DIST_TIMEOUT_S, env={
            "PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "src")]),
            "DIST_STORE": os.path.join(tmp, "store_b"), "DIST_IN": path,
            "DIST_WORK": work, "SORT_FN_KEYS": str(SORT_FN_KEYS),
        },
    )
    ranks = [json.loads(next(x[5:] for x in o.splitlines()
                             if x.startswith("RANK ")))
             for o in outs]
    job_s = time.perf_counter() - t1
    refsum_b = checksum_file(validate, gensort, path)
    for ex in ("batched", "mesh"):
        out = f"{path}.{ex}"
        require(validate.validate_file(out, refsum_b, DIST_RECORDS)["ok"],
                f"(b) {ex} output failed validation")
        sha = sha256(out)
        os.unlink(out)
        require(sha == host_sha, f"(b) {ex} bytes {sha} != host {host_sha}")
        counts = np.array(ranks[0][ex]["partition_counts"])
        spread = counts.std() / counts.mean()
        require(spread < 0.35, f"(b) {ex} ranges {counts.tolist()}")
        agreed = ("partition_counts", "fallbacks", "dispatches", "executor")
        require(all(r[ex][k] == ranks[0][ex][k] for r in ranks for k in agreed),
                f"(b) {ex}: ranks disagree on the counts")
        require(all(r[ex]["launches"]["rmi_bucket"] > 0 for r in ranks),
                f"(b) {ex}: a rank never launched RMI")
        for i, r in enumerate(ranks):
            require_held(r[ex]["held"], r[ex]["launches"],
                         f"(b) {ex} rank {i}")
        dist_launches[f"b_gloo_w{DIST_RANKS}_{ex}"] = {
            k: sum(r[ex]["launches"][k] for r in ranks)
            for k in ranks[0][ex]["launches"]
        }
        log(f"dist: (b) sort_file_distributed gloo x{DIST_RANKS} on "
            f"{ranks[0]['device']}, {DIST_RECORDS} skewed records, {ex}: "
            f"sha256 == host {sha}; ranges {counts.tolist()} (std/mean "
            f"{spread:.4f}); walls "
            f"{[round(r[ex]['wall'], 3) for r in ranks]} s; route capacity "
            f"retries + executor overflows {ranks[0][ex]['fallbacks']}; "
            f"dispatches "
            f"{ranks[0][ex]['dispatches']}; launches by rank "
            f"{[r[ex]['launches'] for r in ranks]}, each held bit-equal "
            f"to its plain version on its own inputs, shapes by rank "
            f"{[{k: sorted(set(map(tuple, v))) for k, v in r[ex]['held'].items()} for r in ranks]}")
    c4 = [r["sort_fn"] for r in ranks]
    require(c4[0]["order_ok"] and c4[0]["lost"] == 0
            and all(c["rmi_err"] == 0 and c["launches"]["rmi_bucket"] > 0
                    for c in c4),
            f"(c) make_sort_fn at {DIST_RANKS} ranks: {c4}")
    dist_launches[f"c_gloo_w{DIST_RANKS}"] = {
        k: sum(c["launches"][k] for c in c4) for k in c4[0]["launches"]
    }
    log(f"dist: (c) make_sort_fn gloo x{DIST_RANKS}, {SORT_FN_KEYS} skewed "
        f"keys a rank: order == np.lexsort, lost 0, n_valid "
        f"{c4[0]['n_valid']}, RMI bit-equal to plain on every rank's "
        f"received words, every launch held bit-equal (rank 0: "
        f"{c4[0]['held']}), sort_device fallbacks "
        f"{[c['fallbacks'] for c in c4]}, seconds "
        f"{[round(c['seconds'], 3) for c in c4]}")
    log(f"dist: (b)+(c) job of {DIST_RANKS} ranks {job_s:.1f} s")
    os.unlink(path)
    for key, name in RESULT_WRAPPERS:
        results[key]["launches_distributed"] = {
            run: by_name[name] for run, by_name in dist_launches.items()
        }
    log(f"dist: phase {time.perf_counter() - t0:.1f} s")


def time_final_rows(torch, kept: list) -> None:
    """The row sorter timed at the widest rows phase (a)'s final pass
    gave it, on those rows: kernel, ``torch.sort`` and plain version,
    beside the bound."""
    from repro_torch.core import encoding
    from repro_torch.kernels import bitonic

    rows = [args for name, args, _ in kept if name == "sort_rows_cuda"]
    hi, lo, val = max(rows, key=lambda a: a[0].numel())
    r, c = hi.shape
    geo = bitonic.launch_geometry(c)
    out = [torch.empty_like(t) for t in (hi, lo, val)]
    ms = cuda_ms(torch, raw_launch(
        torch, "repro_sort_rows", hi, lo, val, *out, r, c, *geo,
    ), reps=10)
    packed = encoding.packed_key(hi, lo)
    lib_ms = cuda_ms(
        torch, lambda: torch.sort(packed, dim=1, stable=True), reps=5
    )
    plain_ms = cuda_ms(
        torch, lambda: bitonic.sort_rows_plain(hi, lo, val), reps=3
    )
    stages = (c.bit_length() - 1) * c.bit_length() // 2
    b_ms, b_by = bound(r * c * (8 + 8 + 4) * 2, r * c // 2 * stages)
    log(f"dist: (a) final-pass rows ({r}, {c}): sort_rows kernel "
        f"{ms:.4f} ms, torch.sort {lib_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}) = {b_ms / ms:.1%} of bound")


@contextlib.contextmanager
def recording_routes():
    """Keep the expert ids and router probabilities of every MoE routing
    call, in call order (wraps ``repro_torch.models.moe.route``)."""
    from repro_torch.models import moe

    calls, route = [], moe.route

    def recorded(p, cfg, xn):
        out = route(p, cfg, xn)
        calls.append((out[3], out[1]))
        return out

    moe.route = recorded
    try:
        yield calls
    finally:
        moe.route = route


def _on_card(torch, extras: dict | None) -> dict:
    return {k: torch.as_tensor(v, device="cuda") for k, v in (extras or {}).items()}


@contextlib.contextmanager
def routes_against(torch, fwd_routes: list, b: int, p: int, n: int, what: str,
                   align: bool):
    """The served pass's MoE routes against ``forward``'s for the same
    tokens (wraps ``repro_torch.models.moe.route``; the calls come as the
    prefill's layers, then each decode step's); yields the list of
    ``(row, position, gap)`` of the tokens routed to other experts, the
    gap between the k-th and (k+1)-th of forward's probabilities.  With
    ``align`` such a token takes forward's experts instead (weighted by
    its own probabilities, renormalised), so that every later layer and
    position stays comparable with forward's; every difference there must
    then sit at a router near-tie (gap within ``LM_ROUTE_MARGIN``), or
    the check fails.  Without it, a difference also moves the later
    layers' routes (their inputs differ), so no gap is judged."""
    from repro_torch.models import moe

    n_moe, route, calls, flips = len(fwd_routes), moe.route, [0], []

    def against(prm, cfg, xn):
        logits, probs, top_p, top_e = route(prm, cfg, xn)
        layer, step = calls[0] % n_moe, calls[0] // n_moe
        calls[0] += 1
        f_ids, f_probs = fwd_routes[layer]
        pos = torch.arange(p, device=xn.device) if step == 0 else torch.full(
            (1,), p + step - 1, device=xn.device)
        tok = (torch.arange(b, device=xn.device)[:, None] * (p + n) + pos).reshape(-1)
        want = f_ids[tok]
        differ = (top_e.sort(-1).values != want.sort(-1).values).any(-1)
        if not bool(differ.any()):
            return logits, probs, top_p, top_e
        k = top_e.shape[-1]
        srt = f_probs[tok[differ]].sort(-1, descending=True).values
        gaps = (srt[:, k - 1] - srt[:, k]).tolist()
        require(not align or max(gaps) < LM_ROUTE_MARGIN,
                f"{what}: a served token at layer {layer}, step {step} routed to "
                f"other experts than forward at a router gap of {max(gaps)}")
        for t, gap in zip(tok[differ].tolist(), gaps):
            flips.append((t // (p + n), t % (p + n) - p + 1, round(gap, 5)))
        if align:
            top_e = torch.where(differ[:, None], want, top_e)
            sel = probs.gather(-1, top_e)
            top_p = torch.where(differ[:, None],
                                sel / torch.clamp_min(sel.sum(-1, keepdim=True), 1e-9), top_p)
        return logits, probs, top_p, top_e

    moe.route = against
    try:
        yield flips
    finally:
        moe.route = route


def lm_check(torch, np, cfg, params, prompts, gen, tol: float, what: str,
             extras: dict | None = None) -> None:
    """The served logits (prefill's last, then ``Model.decode_logits`` fed
    the generated tokens: the engine's own steps) against the port's
    full-sequence forward (``Model.forward``: whisper's runs the encoder,
    the cross K/V and the decoder) over prompt + generated tokens.

    - Each generated token is the served logits' argmax (the engine
      decodes greedily what this pass computes).
    - Every served logit is finite and within ``tol`` of forward's.  Where
      a served token was routed to other MoE experts than forward's, the
      served pass is run again with such tokens given forward's experts
      (``routes_against``), each of which must sit at a router near-tie,
      and that pass is held to ``tol`` at every position (a near-tie
      route otherwise moves its position's logits by up to ~4, and later
      ones through the K/V or the Mamba state).

    Together these hold each generated token to forward's argmax wherever
    forward's top-2 gap exceeds ``2 * tol``, before a row's first route
    difference (there the served pass is the aligned one), so no token
    rule is checked apart."""
    from repro_torch.models.api import build_model

    model = build_model(cfg)
    dev = params.device
    b, p = prompts.shape
    n = gen.shape[1]
    pt = torch.as_tensor(prompts, device=dev)
    gt = torch.as_tensor(gen, device=dev)
    ex = _on_card(torch, extras)
    t0 = time.perf_counter()
    with recording_routes() as fwd_routes:
        logits, _ = model.forward(params, {"tokens": torch.cat([pt, gt], 1), **ex})
    fwd = logits[:, p - 1 : p - 1 + n]
    del logits

    def served_pass(align: bool):
        with routes_against(torch, fwd_routes, b, p, n, what, align) as flips:
            last, cache = model.prefill(params, {"tokens": pt, **ex}, max_seq=p + n)
            out = [last[:, None]]
            for j in range(n - 1):
                out.append(model.decode_logits(params, cache, gt[:, j : j + 1]))
        return torch.cat(out, 1), flips

    served, differ = served_pass(align=False)
    require(bool(torch.isfinite(fwd).all() and torch.isfinite(served).all()),
            f"{what}: logits are not finite")
    require(bool((served.argmax(-1) == gt).all()),
            f"{what}: a generated token is not the served logits' argmax")
    flips = []
    if differ:
        served, flips = served_pass(align=True)
    d = (served - fwd).abs().amax(-1)
    worst = float(d.max())
    require(worst <= tol, f"{what}: served logits differ from forward's by "
            f"{worst} > {tol} (per position: {d.tolist()})")
    log(f"lm: {what} check ({time.perf_counter() - t0:.2f} s): served vs forward "
        f"logits max |diff| {worst:.4f} <= {tol} over all {d.numel()} positions "
        f"(median of the per-position maxima {float(d.median()):.4f}); "
        f"{len(differ)} served routes differed from forward's, at (row, "
        f"position) {sorted({(row, pos) for row, pos, _ in differ})}; with "
        f"forward's experts there {len(flips)} near-tie routes remain "
        f"({sum(pos <= 0 for _, pos, _ in flips)} in the prefill; gaps "
        f"{[g for _, _, g in flips]}), aligned for the comparison")


def lm_serve(torch, np, cfg, params, prompts, new: int, what: str,
             extras: dict | None = None) -> dict:
    """``ServeEngine.generate`` on the card under a device trace; logs
    prefill and decode times, tokens/s and peak memory."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeEngine

    engine = ServeEngine(build_model(cfg), params=params)
    ops.reset_launches()
    with keep_launches() as kept, count_dispatches() as dispatches:
        prof = start_device_trace(torch)
        t0 = time.perf_counter()
        gen = engine.generate(prompts, new, **(extras or {}))
        wall = time.perf_counter() - t0
        launches = launch_counts()
    log_device_time(prof, f"lm: {what}", wall)
    st = engine.stats
    b = prompts.shape[0]
    require(st.logits_finite, f"{what}: served logits are not finite")
    require(gen.shape == (b, new), f"{what}: generated {gen.shape}")
    require_lm_launches(torch, kept, launches, dispatches[0], f"{what} serving")
    res = dict(
        prefill_ms=st.prefill_seconds * 1e3,
        decode_ms_per_step=st.decode_seconds * 1e3 / max(st.decode_steps, 1),
        decode_tokens_per_s=b * st.decode_steps / max(st.decode_seconds, 1e-9),
        tokens_per_s=b * new / wall,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log(f"lm: {what} served {b} x {prompts.shape[1]} prompt tokens + {new} new "
        f"in {wall:.2f} s: prefill {res['prefill_ms']:.1f} ms, decode "
        f"{res['decode_ms_per_step']:.2f} ms a step ({st.decode_steps} steps, "
        f"{res['decode_tokens_per_s']:.1f} tokens/s), {res['tokens_per_s']:.1f} "
        f"new tokens/s end to end, peak memory {res['peak_gb']:.2f} GB; "
        f"kernel launches {launches} for {dispatches[0]} MoE dispatches, each "
        f"held bit-equal")
    return {"gen": gen, "launches": launches, **res}


def lm_init(torch, cfg, what: str, note: str = ""):
    """Seeded f32 parameters on the card, through the model facade; logs
    their count."""
    from repro_torch.models.api import build_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init_params(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"lm: {what} {cfg.name}: {cfg.n_layers} layers{note}, d {cfg.d_model}, "
        f"{n_params} parameters ({n_params * 4 / 1e9:.2f} GB f32) initialised "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    return params, t0


def lm_done(torch, what: str, t0: float) -> None:
    import gc

    log(f"lm: {what} peak memory with the check "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {what} "
        f"{time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()


def _synthetic(cfg, seq: int, batch: int):
    from repro_torch.data.pipeline import PipelineConfig, SyntheticLM

    return SyntheticLM(PipelineConfig(cfg.vocab_raw, seq, batch)).batch_at(0)["tokens"]


def _no_drop(cfg):
    """Capacity factor n_experts / top_k: no MoE token is dropped."""
    import dataclasses

    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def log_default_drop(torch, cfg, params, prompt, what: str) -> None:
    """The default capacity factor's ``moe_dropped_frac`` on the prompt."""
    from repro_torch.models import transformer

    _, aux = transformer.forward(cfg, params, torch.as_tensor(prompt, device="cuda"))
    n_moe = sum(k == "moe" for period in params.periods for k in period)
    log(f"lm: {what} prefill of {prompt.shape[1]} tokens at the default capacity "
        f"factor {cfg.moe.capacity_factor}: moe_dropped_frac "
        f"{float(aux['moe_dropped_frac']) / n_moe:.4f} a MoE layer "
        f"(summed over {n_moe} layers {float(aux['moe_dropped_frac']):.4f})")


def lm_cuda_vs_cpu(torch, np, arch: str) -> None:
    """(c) One smoke arch on the card and on the host with the same
    parameters: forward and prefill logits within ``LM_TOL``, served
    tokens under the token rule, ``bucket_matrix`` on the MoE archs'
    expert ids bit-equal."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.core import partition
    from repro_torch.models import layers, moe, transformer
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeEngine

    cfg = registry.get_config(arch, smoke=True)
    model = build_model(cfg)
    cpu = model.init_params(seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    toks = _synthetic(cfg, 16, 2)
    extras = {}
    if cfg.frontend != "none":
        extras["frontend_embeds"] = np.random.default_rng(0).standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    worst = 0.0
    for fn in (model.forward, model.prefill):
        out = []
        for params, dev in ((cpu, "cpu"), (gpu, "cuda")):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in {"tokens": toks, **extras}.items()}
            out.append(fn(params, batch)[0].cpu())
        require(torch.allclose(out[1], out[0], atol=LM_TOL, rtol=LM_TOL),
                f"{arch}: {fn.__name__} logits on the card differ from the "
                f"host's by {float((out[1] - out[0]).abs().max())}")
        worst = max(worst, float((out[1] - out[0]).abs().max()))
    gens = [ServeEngine(model, params=p, device=d).generate(
        toks[:, :8], 8, **extras) for p, d in ((cpu, "cpu"), (gpu, "cuda"))]
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vit" else 0
    ref = model.forward(cpu, {
        "tokens": torch.as_tensor(np.concatenate([toks[:, :8], gens[0]], 1)),
        **{k: torch.as_tensor(v) for k, v in extras.items()},
    })[0][:, n_front + 7 : n_front + 15]
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > LM_TOKEN_MARGIN).numpy()
    for g, w, c in zip(gens[1], gens[0], clear):
        # equal up to the first differing token, which must not be clear
        diff = np.nonzero(g != w)[0]
        require(not len(diff) or not c[diff[0]],
                f"{arch}: served tokens on the card differ from the host's at "
                f"a clear position")
    msg = f"lm: (c) {arch}: card vs host logits max |diff| {worst:.4f}"
    if cfg.moe:
        p = next(layer[slot] for layer in cpu.layers for slot in layer
                 if slot.endswith("moe"))
        x = transformer.embed_inputs(cfg, cpu, torch.as_tensor(toks))
        xn = layers.rms_norm(x, p.norm, cfg.norm_eps).reshape(-1, cfg.d_model)
        ids = moe.route(p, cfg, xn)[3].reshape(-1).to(torch.int32)
        capacity = moe._round_up(max(int(
            ids.numel() / cfg.moe.n_experts * cfg.moe.capacity_factor), 8), 8)
        host = partition.bucket_matrix(ids, cfg.moe.n_experts, capacity)
        card = partition.bucket_matrix(ids.cuda(), cfg.moe.n_experts, capacity)
        require(all(torch.equal(h, c.cpu()) for h, c in zip(host, card)),
                f"{arch}: bucket_matrix on the card differs from the host's")
        msg += (f"; bucket_matrix bit-equal on {ids.numel()} expert ids "
                f"(capacity {capacity}, counts {host[2].tolist()})")
    log(msg)


def lm_a(torch, np) -> dict:
    """(a) qwen3-4b, full width and depth; returns the sorter kernel
    launches while serving."""
    from repro_torch.configs import registry

    cfg = registry.get_config("qwen3-4b")
    params, t1 = lm_init(torch, cfg, "(a)")
    prompts = _synthetic(cfg, LM_PROMPT_LEN, LM_PROMPTS)
    a = lm_serve(torch, np, cfg, params, prompts, LM_NEW, "(a) qwen3-4b")
    lm_check(torch, np, cfg, params, prompts, a["gen"], LM_TOL_DEEP, "(a) qwen3-4b")
    del params
    lm_done(torch, "(a)", t1)
    return a["launches"]


def lm_b(torch, np) -> dict:
    """(b) mixtral-8x7b, full width, 2 of its 32 layers."""
    import dataclasses

    from repro_torch.configs import registry

    full = registry.get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=LM_MIXTRAL_LAYERS)
    wide = _no_drop(cfg)
    params, t1 = lm_init(torch, cfg, "(b)", f" of {full.n_layers}")
    log(f"lm: (b) window {cfg.window}, capacity factor "
        f"{wide.moe.capacity_factor} served")
    prompt = _synthetic(cfg, LM_LONG_PROMPT, 1)
    log_default_drop(torch, cfg, params, prompt, "(b)")
    b = lm_serve(torch, np, wide, params, prompt, LM_LONG_NEW, "(b) mixtral")
    lm_check(torch, np, wide, params, prompt, b["gen"], LM_TOL_SHALLOW, "(b) mixtral")
    del params
    lm_done(torch, "(b)", t1)
    return b["launches"]


def lm_d(torch, np) -> dict:
    """(d) jamba-v0.1-52b, full width, one period of its 32 layers."""
    import dataclasses

    from repro_torch.configs import registry

    full = registry.get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=LM_JAMBA_LAYERS)
    wide = _no_drop(cfg)
    period = cfg.layer_plan()[0][1]
    params, t1 = lm_init(torch, cfg, "(d)", f" of {full.n_layers} (one period: " + ", ".join(
        f"{period.count(k)} {k}" for k in sorted(set(period))) + ")")
    log(f"lm: (d) d_inner {cfg.mamba.expand * cfg.d_model}, d_state "
        f"{cfg.mamba.d_state}, capacity factor {wide.moe.capacity_factor} served")
    prompt = _synthetic(cfg, LM_JAMBA_PROMPT, 1)
    log_default_drop(torch, cfg, params, prompt, "(d)")
    d = lm_serve(torch, np, wide, params, prompt, LM_JAMBA_NEW, "(d) jamba")
    lm_check(torch, np, wide, params, prompt, d["gen"], LM_TOL_JAMBA, "(d) jamba")
    del params
    lm_done(torch, "(d)", t1)
    return d["launches"]


def lm_e(torch, np) -> dict:
    """(e) xlstm-350m, full width and depth."""
    from repro_torch.configs import registry

    cfg = registry.get_config("xlstm-350m")
    params, t1 = lm_init(torch, cfg, "(e)")
    prompts = _synthetic(cfg, LM_XLSTM_PROMPT, LM_PROMPTS)
    e = lm_serve(torch, np, cfg, params, prompts, LM_NEW, "(e) xlstm")
    lm_check(torch, np, cfg, params, prompts, e["gen"], LM_TOL_XLSTM, "(e) xlstm")
    del params
    lm_done(torch, "(e)", t1)
    return e["launches"]


def lm_f(torch, np) -> dict:
    """(f) whisper-medium, full width and depth; stub frames from a seed,
    the encoder timed apart."""
    from repro_torch.configs import registry
    from repro_torch.models import encdec

    cfg = registry.get_config("whisper-medium")
    params, t1 = lm_init(torch, cfg, "(f)", f" + {cfg.n_enc_layers} encoder")
    prompts = _synthetic(cfg, LM_WHISPER_PROMPT, LM_WHISPER_REQUESTS)
    extras = {"frontend_embeds": np.random.default_rng(0).standard_normal(
        (LM_WHISPER_REQUESTS, cfg.n_frontend_tokens, cfg.d_frontend)
    ).astype(np.float32)}
    f = lm_serve(torch, np, cfg, params, prompts, LM_WHISPER_NEW, "(f) whisper", extras)
    frames = _on_card(torch, extras)["frontend_embeds"]
    enc_ms = cuda_ms(torch, lambda: encdec.cross_caches(
        cfg, params, encdec.encode(cfg, params, frames)), reps=3, cold=False)
    log(f"lm: (f) encoder + cross K/V of {LM_WHISPER_REQUESTS} x "
        f"{cfg.n_frontend_tokens} frames {enc_ms:.1f} ms on the card (CUDA "
        f"events, median of 3) of the prefill's {f['prefill_ms']:.1f} ms; the "
        f"decoder's {LM_WHISPER_NEW - 1} steps {f['decode_ms_per_step']:.2f} ms each")
    lm_check(torch, np, cfg, params, prompts, f["gen"], LM_TOL_WHISPER, "(f) whisper",
             extras)
    del params, frames
    lm_done(torch, "(f)", t1)
    return f["launches"]


def phase_lm(torch, results: dict) -> None:
    """11. The LM serving path (see the module docstring)."""
    import numpy as np

    t0 = time.perf_counter()
    # the reference's products accumulate in f32: no TF32, no bf16 split-K
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # serving records no autograd graph
    with torch.inference_mode():
        lm_launches = {key: fn(torch, np) for key, fn in (
            ("a", lm_a), ("b", lm_b), ("d", lm_d), ("e", lm_e), ("f", lm_f))}

        # (c) every arch at smoke size, card against host
        t1 = time.perf_counter()
        for arch in LM_ARCHS:
            lm_cuda_vs_cpu(torch, np, arch)
        log(f"lm: (c) {time.perf_counter() - t1:.1f} s")
    for key, name in RESULT_WRAPPERS:
        results[key]["launches_lm"] = {
            run: by_name[name] for run, by_name in lm_launches.items()
        }
    log(f"lm: kernel launches while serving (the histogram's: one a MoE "
        f"dispatch) {lm_launches}")
    log(f"lm: phase {time.perf_counter() - t0:.1f} s")


def lm_train(torch, np, cfg, params, batch: dict, steps: int, what: str,
             traced: int | None = None) -> dict:
    """``steps`` train steps of ``train_loop.build_train_step`` (the
    launcher's step: AdamW, per-layer remat, bf16 gradients) on one
    repeated batch (host arrays: ``tokens``, and ``frontend_embeds``
    where the arch takes them), the last ``traced`` of them (all by
    default) under a device trace.  Checks: every
    loss, norm and parameter finite; ``grad_norm`` > 0; the first step's
    ``loss_total`` within ``LM_TOL`` of ``loss_fn`` under
    ``inference_mode``; the last loss below the first; the kernels
    launched as ``require_lm_launches`` says.  Logs ms a step, tokens/s, peak memory and the device
    trace."""
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.train import optimizer as opt_lib, train_loop

    model = build_model(cfg)
    model.trainable(params)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    with torch.inference_mode():
        want = float(model.loss_fn(params, batch)[0])
    opt_state = opt_lib.init_state(params)
    step = train_loop.build_train_step(model, opt_lib.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=steps))
    traced = steps if traced is None else traced
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses, norms, drops, ms = [], [], [], []
    with keep_launches() as kept, count_dispatches() as dispatches:
        for i in range(steps):
            if i == steps - traced:
                prof, t_trace = start_device_trace(torch), time.perf_counter()
            t1 = time.perf_counter()
            _, _, m = step(params, opt_state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(m["loss_total"]))
            norms.append(float(m["grad_norm"]))
            drops.append(float(m.get("moe_dropped_frac", 0.0)))  # no MoE metrics: 0
        wall = time.perf_counter() - t0
        launches = launch_counts()
    log_device_time(prof, f"train: {what}" + (f" (the last {traced} of {steps} steps)"
                                              if traced < steps else ""),
                    time.perf_counter() - t_trace)
    finite = all(bool(torch.isfinite(p).all()) for p in params.parameters())
    require(finite and all(np.isfinite(losses + norms)),
            f"{what}: a loss, norm or parameter is not finite ({losses}, {norms})")
    require(norms[0] > 0, f"{what}: grad_norm {norms[0]}")
    require(abs(losses[0] - want) <= LM_TOL,
            f"{what}: step 0 loss_total {losses[0]} against loss_fn's {want}")
    require(losses[-1] < losses[0], f"{what}: the loss did not fall: {losses}")
    require_lm_launches(torch, kept, launches, dispatches[0], f"{what} training")
    n_tok = int(batch["tokens"].numel())
    steady = statistics.median(ms[1:])
    n_moe = sum(k == "moe" for period in params.periods for k in period)
    frames = (f" and {tuple(batch['frontend_embeds'].shape)} frames"
              if "frontend_embeds" in batch else "")
    log(f"train: {what} {steps} steps on {tuple(batch['tokens'].shape)} tokens{frames} in "
        f"{wall:.2f} s: step 0 {ms[0]:.1f} ms, then median {steady:.1f} ms a step "
        f"({[round(x, 1) for x in ms]}), {n_tok / steady * 1e3:.1f} tokens/s; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; kernel "
        f"launches {launches} for {dispatches[0]} MoE dispatches, each held "
        f"bit-equal")
    log(f"train: {what} loss_total {[round(x, 4) for x in losses]} (loss_fn under "
        f"inference_mode {want:.4f}, step 0 differs by {abs(losses[0] - want):.2e}); "
        f"grad_norm {[round(x, 3) for x in norms]}"
        + (f"; moe_dropped_frac a MoE layer {[round(x / n_moe, 4) for x in drops]}"
           if n_moe else ""))
    del opt_state, step
    return launches


def train_a(torch, np) -> dict:
    """(a) qwen3-4b, full width and depth."""
    from repro_torch.configs import registry

    cfg = registry.get_config("qwen3-4b")
    params, t1 = lm_init(torch, cfg, "(a) train")
    batch = {"tokens": _synthetic(cfg, TRAIN_A_SEQ, TRAIN_A_BATCH)}
    launches = lm_train(torch, np, cfg, params, batch, TRAIN_A_STEPS, "(a) qwen3-4b")
    del params
    lm_done(torch, "(a) train", t1)
    return launches


def train_b(torch, np) -> dict:
    """(b) mixtral-8x7b, full width, 2 of its 32 layers, default capacity."""
    import dataclasses

    from repro_torch.configs import registry

    full = registry.get_config("mixtral-8x7b")
    cfg = dataclasses.replace(full, n_layers=LM_MIXTRAL_LAYERS)
    params, t1 = lm_init(torch, cfg, "(b) train", f" of {full.n_layers}")
    log(f"lm: (b) train: window {cfg.window}, capacity factor "
        f"{cfg.moe.capacity_factor}")
    batch = {"tokens": _synthetic(cfg, TRAIN_B_SEQ, 1)}
    launches = lm_train(torch, np, cfg, params, batch, TRAIN_B_STEPS, "(b) mixtral")
    del params
    lm_done(torch, "(b) train", t1)
    return launches


def train_d(torch, np) -> dict:
    """(d) xlstm-350m, full width and depth."""
    from repro_torch.configs import registry

    cfg = registry.get_config("xlstm-350m")
    params, t1 = lm_init(torch, cfg, "(d) train")
    batch = {"tokens": _synthetic(cfg, TRAIN_D_SEQ, TRAIN_D_BATCH)}
    launches = lm_train(torch, np, cfg, params, batch, TRAIN_D_STEPS, "(d) xlstm-350m",
                        traced=TRAIN_D_TRACED)
    del params
    lm_done(torch, "(d) train", t1)
    return launches


def train_e(torch, np) -> dict:
    """(e) whisper-medium, full width and depth, on seeded stub frames."""
    from repro_torch.configs import registry

    cfg = registry.get_config("whisper-medium")
    params, t1 = lm_init(torch, cfg, "(e) train", f" + {cfg.n_enc_layers} encoder")
    batch = {"tokens": _synthetic(cfg, TRAIN_E_SEQ, TRAIN_E_BATCH),
             "frontend_embeds": np.random.default_rng(0).standard_normal(
                 (TRAIN_E_BATCH, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)}
    launches = lm_train(torch, np, cfg, params, batch, TRAIN_E_STEPS, "(e) whisper-medium")
    del params
    lm_done(torch, "(e) train", t1)
    return launches


TRAIN_RUNS = (("a", train_a), ("b", train_b), ("d", train_d), ("e", train_e))


def _train_batch(torch, np, cfg, dev) -> dict:
    """(c)'s batch: 4 x 16 ``SyntheticLM`` tokens, with seeded patches or
    frames where the arch takes them."""
    batch = {"tokens": _synthetic(cfg, 16, 4)}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = np.random.default_rng(0).standard_normal(
            (4, cfg.n_frontend_tokens, cfg.d_frontend)).astype(np.float32)
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def train_cuda_vs_cpu(torch, np, arch: str, microbatches: int = 1) -> None:
    """(c) One smoke arch on the card and on the host with the same
    parameters: ``grads_of``'s bf16 gradients within ``TRAIN_GRAD_TOL``
    leaf by leaf (relative L2, floored at ``TRAIN_GRAD_FLOOR`` of the
    whole gradient), then one ``build_train_step`` step: loss within
    ``LM_TOL``, update within ``dd < TRAIN_UPDATE_TOL * d1``."""
    import copy

    from repro_torch.configs import registry
    from repro_torch.models.api import build_model
    from repro_torch.train import optimizer as opt_lib, train_loop

    cfg = registry.get_config(arch, smoke=True)
    model = build_model(cfg)
    cpu = model.trainable(model.init_params(seed=0, device="cpu"))
    gpu = copy.deepcopy(cpu).to("cuda")
    host = _train_batch(torch, np, cfg, "cpu")
    card = _train_batch(torch, np, cfg, "cuda")
    _, _, gc = train_loop.grads_of(model, cpu, host, microbatches=microbatches)
    _, _, gg = train_loop.grads_of(model, gpu, card, microbatches=microbatches)
    require(all(bool(torch.isfinite(g).all()) for g in gg.values()),
            f"{arch}: a gradient on the card is not finite")
    total = sum(float(g.float().square().sum()) for g in gc.values()) ** 0.5
    errs = {n: float((gg[n].float().cpu() - g.float()).norm())
            / max(float(g.float().norm()), TRAIN_GRAD_FLOOR * total) for n, g in gc.items()}
    leaf, worst = max(errs.items(), key=lambda kv: kv[1])
    require(worst <= TRAIN_GRAD_TOL, f"{arch}: gradient {leaf} on the card differs "
            f"from the host's by {worst} relative L2")
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    step = train_loop.build_train_step(model, opt_lib.AdamWConfig(lr=1e-3, warmup_steps=1),
                                       microbatches=microbatches)
    _, _, mc = step(cpu, opt_lib.init_state(cpu), host)
    _, _, mg = step(gpu, opt_lib.init_state(gpu), card)
    dl = abs(float(mg["loss_total"]) - float(mc["loss_total"]))
    require(dl <= LM_TOL, f"{arch}: step loss on the card differs by {dl}")
    d1 = sum(float((p.detach() - before[n]).abs().sum()) for n, p in cpu.named_parameters())
    dd = sum(float((g.detach().cpu() - c.detach()).abs().sum())
             for g, c in zip(gpu.parameters(), cpu.parameters()))
    require(dd < TRAIN_UPDATE_TOL * d1, f"{arch}: update on the card differs from the "
            f"host's: dd {dd} >= {TRAIN_UPDATE_TOL} * d1 {d1}")
    log(f"train: (c) {arch}{f' microbatches={microbatches}' if microbatches > 1 else ''}: "
        f"card vs host loss |diff| {dl:.2e}, worst gradient leaf {leaf} {worst:.4f} "
        f"relative L2, update dd/d1 {dd / d1:.4f}")


def train_resume_on_card(np, tmp: str) -> None:
    """(c) ``launch.train.train`` on the card (its default device), stopped
    at step 4 with a checkpoint and resumed, against the uninterrupted
    run (the reference's ``test_train_resume_equivalence``)."""
    from repro_torch.launch.train import train

    kw = dict(smoke=True, steps=8, batch=4, seq=16, mesh_shape=(1,), log_every=100)
    d = os.path.join(tmp, "ck")
    full = train("qwen3-4b", **kw)
    train("qwen3-4b", **{**kw, "steps": 4}, ckpt_dir=d, ckpt_every=4)
    resumed = train("qwen3-4b", **kw, ckpt_dir=d, ckpt_every=100)
    rel = float(np.max(np.abs(np.asarray(resumed) / np.asarray(full[4:]) - 1)))
    require(rel <= TRAIN_RESUME_RTOL, f"resumed losses {resumed} against {full[4:]}")
    log(f"train: (c) launch.train on the card, resumed at step 4 from a checkpoint: "
        f"losses {[round(x, 4) for x in resumed]} against the uninterrupted "
        f"{[round(x, 4) for x in full[4:]]}, largest relative difference {rel:.2e}")


def phase_train(torch, results: dict, runs: str = "abde") -> None:
    """12. The LM training path (see the module docstring); ``runs``: the
    full-size runs to make, by key (``experiments/lm_paths.py`` runs a
    few alone)."""
    import numpy as np

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    train_launches = {key: fn(torch, np) for key, fn in TRAIN_RUNS if key in runs}

    t1 = time.perf_counter()
    ops.reset_launches()
    with keep_launches() as kept, count_dispatches() as dispatches:
        for arch in LM_ARCHS:
            train_cuda_vs_cpu(torch, np, arch)
        train_cuda_vs_cpu(torch, np, "yi-9b", microbatches=2)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            train_resume_on_card(np, tmp)
        train_launches["c"] = launch_counts()
    require_lm_launches(torch, kept, train_launches["c"], dispatches[0],
                        "(c) training")
    kept.clear()
    log(f"train: (c) {time.perf_counter() - t1:.1f} s")
    for key, name in RESULT_WRAPPERS:
        results[key]["launches_train"] = {
            run: by_name[name] for run, by_name in train_launches.items()
        }
    log(f"train: kernel launches while training (the histogram's: one a MoE "
        f"dispatch) {train_launches}")
    log(f"train: phase {time.perf_counter() - t0:.1f} s")


# 13. The sharded LM step.  (a) qwen3-4b at full width, MESH_LAYERS of its
# 36 layers, on a MESH_SHAPE ("data", "model") mesh of MESH_BACKEND ranks,
# MESH_STEPS AdamW steps on one repeated batch of MESH_BATCH x MESH_SEQ
# tokens, against the plain single-rank step from the same parameters:
# every loss_total within MESH_LOSS_TOL, step 0's update within the
# reference's microbatch check (dd < 0.35 d1) on MESH_LEAVES.  (b)
# launch.train at smoke size on the same ranks, stopped at step 2, resumed
# on (world, 1) and on one rank: the uninterrupted losses within 2e-2.
# After (a), one sequence served on the same mesh (MESH_B1_*) against the
# plain path.  (c) three dry-run cells in subprocesses, started before
# phase 12 (their CPU time, 203 s for qwen3-4b train_4k, then hides behind
# phases 12 and 13): xlstm-350m train_4k (its sLSTM loop counted one step
# for all, models/recurrence.py) traced in 50.5 s on the card machine's CPU.
# Several gloo ranks sharing the card cannot carry DTensor: plain gloo
# collectives on CUDA tensors run, but DTensor's first redistribution on a
# 2 x 2 mesh ends the process with SIGSEGV (experiments/gloo_cuda_probe.py),
# and NCCL puts no two ranks on one card.  So the sharded step runs at
# world size 1 on NCCL, on a (1, 1) mesh over the full 36 layers (the
# DTensor path at full size), on phase 12's batch of 2 x 1,024 (its 65 GB
# peak leaves no room for 4 x 1,024 beside 61.8 GB of state); the tests
# hold the multi-rank step on gloo CPU ranks.
MESH_SHAPE, MESH_LAYERS, MESH_STEPS, MESH_BATCH, MESH_SEQ = (1, 1), 36, 4, 2, 1024
# after (a): one sequence served on the same mesh against the plain path,
# within phase 11's bound for qwen3-4b's 36 layers
MESH_B1_PROMPT, MESH_B1_STEPS, MESH_B1_TOL = 24, 4, LM_TOL_DEEP
MESH_BACKEND = "nccl"
MESH_LOSS_TOL = 1e-2
MESH_LEAVES = ("embed", "layers.0.00_attn.wq", "layers.3.01_mlp.w_down", "final_norm")
MESH_DRYRUN = (("qwen3-4b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
               ("xlstm-350m", "train_4k"))


def _mesh_cfg():
    import dataclasses

    from repro_torch.configs import registry

    return dataclasses.replace(registry.get_config("qwen3-4b"), n_layers=MESH_LAYERS)


def _mesh_step(torch, np, params, model):
    """The phase's step function, batch and optimizer state."""
    from repro_torch.train import optimizer as opt_lib, train_loop

    cfg = model.cfg
    batch = {"tokens": torch.as_tensor(_synthetic(cfg, MESH_SEQ, MESH_BATCH), device="cuda")}
    opt_state = opt_lib.init_state(params)
    step = train_loop.build_train_step(model, opt_lib.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=MESH_STEPS))
    return step, batch, opt_state


def _mesh_leaves(params, full) -> dict:
    """MESH_LEAVES of ``params`` as host tensors (DTensors gathered)."""
    named = dict(params.named_parameters())
    return {n: full(named[n]).detach().float().cpu() for n in MESH_LEAVES}


def mesh_single(torch, np, out: str) -> dict:
    """(a)'s reference: the plain single-rank step on the card; saves
    step 0's update of MESH_LEAVES to ``out``."""
    from repro_torch.models.api import build_model

    model = build_model(_mesh_cfg())
    params = model.trainable(model.init_params(seed=0))
    step, batch, opt_state = _mesh_step(torch, np, params, model)
    before = _mesh_leaves(params, lambda t: t)
    losses, ms = [], []
    for i in range(MESH_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, _, m = step(params, opt_state, batch)
        losses.append(float(m["loss_total"]))
        ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            after = _mesh_leaves(params, lambda t: t)
            torch.save({n: after[n] - before[n] for n in MESH_LEAVES}, out)
    n_params = sum(p.numel() for p in params.parameters())
    del params, opt_state, step
    return {"losses": losses, "ms": ms, "n_params": n_params,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def mesh_serve_batch1(torch, model, mesh) -> dict:
    """(a)'s batch-1 serving check: a prefill of MESH_B1_PROMPT tokens and
    MESH_B1_STEPS teacher-forced decode steps of one sequence, first on
    plain parameters, then on the same parameters laid out on ``mesh``
    (every batch placement ``Replicate`` on its size-1 axes); returns the
    largest logit difference, the times and the batch's layout."""
    from repro_torch.sharding import rules, spmd

    n = MESH_B1_PROMPT + MESH_B1_STEPS
    tok = torch.as_tensor(_synthetic(model.cfg, n, 1), device="cuda")
    params = model.init_params(seed=0)
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        if m is not None:
            rules.set_active_mesh(m)
            spmd.distribute_params(params, m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), spmd.maybe_sharded(m):
            b = {"tokens": tok[:, :MESH_B1_PROMPT]}
            if m is not None:
                b = spmd.shard_batch(b, m)
            last, cache = model.prefill(params, b, max_seq=n)
            logits = [spmd.full(last).float()]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t in range(MESH_B1_STEPS):
                nxt = tok[:, MESH_B1_PROMPT + t:MESH_B1_PROMPT + t + 1]
                if m is not None:
                    nxt = spmd.shard_batch({"t": nxt}, m)["t"]
                logits.append(spmd.full(model.decode_logits(params, cache, nxt))[:, -1].float())
            torch.cuda.synchronize()
        out[name] = {"logits": torch.stack(logits), "prefill_ms": (t1 - t0) * 1e3,
                     "decode_ms": (time.perf_counter() - t1) * 1e3 / MESH_B1_STEPS}
        if m is not None:
            out[name]["layout"] = [str(p) for p in spmd.batch_placements(m, 1)]
            rules.set_active_mesh(None)
    want, got = out["plain"].pop("logits"), out["mesh"].pop("logits")
    del params, cache
    torch.cuda.empty_cache()
    return {"max_abs": float((got - want).abs().max()),
            "finite": bool(torch.isfinite(got).all()), **out}


def mesh_rank() -> None:
    """One rank of phase 13, spawned by ``phase_mesh``: (a) the sharded
    step of ``_mesh_cfg()`` on MESH_SHAPE, (b) ``launch.train`` stopped
    and resumed; prints one ``RANK`` JSON line, with the sorter kernels'
    launches of (a) and (b) on this rank."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import cost_analysis, mesh as tmesh
    from repro_torch.launch.train import train
    from repro_torch.models.api import build_model
    from repro_torch.sharding import rules, spmd

    env = os.environ
    shape = tuple(json.loads(env["MESH_SHAPE"]))
    tmesh.initialize_multiprocess(
        f"file://{env['MESH_STORE']}", int(env["WORLD_SIZE"]), int(env["RANK"]),
        backend=env["MESH_BACKEND"], device="cuda", timeout_s=300)
    rank = torch.distributed.get_rank()
    ops.reset_launches()
    mesh = tmesh.make_device_mesh(shape, ("data", "model"))
    rules.set_active_mesh(mesh)
    model = build_model(_mesh_cfg())
    params = model.trainable(model.init_params(seed=0))
    spmd.distribute_params(params, mesh)
    torch.cuda.empty_cache()
    step, batch, opt_state = _mesh_step(torch, np, params, model)
    before = _mesh_leaves(params, spmd.full)
    losses, ms, colls = [], [], {}
    for i in range(MESH_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == MESH_STEPS - 1:  # the collectives of one step, counted
            with cost_analysis.CostMode() as mode:
                _, _, m = step(params, opt_state, batch)
            colls = mode.cost.as_dict()["collectives"]
        else:
            _, _, m = step(params, opt_state, batch)
        losses.append(float(m["loss_total"]))
        ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            after = _mesh_leaves(params, spmd.full)
            upd = {n: after[n] - before[n] for n in MESH_LEAVES}
    res = {"losses": losses, "ms": ms, "collectives": colls,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "placements": {n: [str(p) for p in dict(params.named_parameters())[n].placements]
                          for n in MESH_LEAVES}}
    if rank == 0:
        ref = torch.load(env["MESH_REF"])
        d1 = sum(float(ref[n].abs().sum()) for n in MESH_LEAVES)
        dd = sum(float((upd[n] - ref[n]).abs().sum()) for n in MESH_LEAVES)
        res["update"] = {"d1": d1, "dd": dd}
    del params, opt_state, step
    rules.set_active_mesh(None)
    torch.cuda.empty_cache()
    res["batch1"] = mesh_serve_batch1(torch, model, mesh)
    # (b) the launcher at smoke size, stopped at step 2 and resumed
    kw = dict(smoke=True, steps=4, batch=4, seq=16, log_every=100)
    ck = env["MESH_CKPT"]
    res["b_full"] = train("qwen3-4b", mesh_shape=shape, **kw)
    train("qwen3-4b", mesh_shape=shape, ckpt_dir=ck, ckpt_every=2, **{**kw, "steps": 2})
    res["b_resumed_4x1"] = train("qwen3-4b", mesh_shape=(int(env["WORLD_SIZE"]), 1),
                                 ckpt_dir=ck, ckpt_every=100, **kw)
    res["launches"] = launch_counts()
    print("RANK " + json.dumps(res), flush=True)
    tmesh.exit_rank()


def start_dryrun() -> tuple:
    """(c) the dry run's cells, each in a process of its own (a fake
    process group), started on the host's cores, their output to files
    (no pipe fills while they run); ``phase_mesh`` reads them and
    ``stop_dryrun`` ends them."""
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    started = []
    for arch, shape in MESH_DRYRUN:
        with open(os.path.join(dry_dir, f"{arch}__{shape}.log"), "w") as out:
            started.append((arch, shape, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", "single", "--out", dry_dir],
                env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                stdout=out, stderr=subprocess.STDOUT)))
    return dry_dir, started


def stop_dryrun(started: tuple) -> None:
    dry_dir, dry = started
    for _, _, _, proc in dry:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(dry_dir, ignore_errors=True)


def phase_mesh(torch, results: dict, started: tuple | None = None) -> None:
    """13. The sharded LM step (see the module docstring); ``started``:
    the dry run's cells from ``start_dryrun``, started earlier (by default
    they start here, beside (a) and (b))."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.train import train

    t0 = time.perf_counter()
    ops.reset_launches()
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    started = started or start_dryrun()
    dry_dir, dry = started
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            torch.cuda.reset_peak_memory_stats()
            ref = mesh_single(torch, np, os.path.join(tmp, "ref.pt"))
            torch.cuda.empty_cache()
            log(f"mesh: (a) single rank qwen3-4b {MESH_LAYERS} of 36 layers, "
                f"{ref['n_params']} parameters: loss_total "
                f"{[round(x, 4) for x in ref['losses']]}, ms a step "
                f"{[round(x, 1) for x in ref['ms']]}, peak {ref['peak_gb']:.2f} GB")
            t1 = time.perf_counter()
            outs = tmesh.spawn(
                "import chip_smoke; chip_smoke.mesh_rank()", world, timeout_s=900,
                env={"PYTHONPATH": os.path.join(ROOT, "src") + os.pathsep + ROOT,
                     "MESH_STORE": os.path.join(tmp, "store"), "MESH_REF": os.path.join(tmp, "ref.pt"),
                     "MESH_CKPT": os.path.join(tmp, "ck"), "MESH_BACKEND": MESH_BACKEND,
                     "MESH_SHAPE": json.dumps(MESH_SHAPE)})
            ranks = [json.loads([s for s in out.splitlines() if s.startswith("RANK ")][-1][5:])
                     for out in outs]
            res = ranks[0]
            ranks_s = time.perf_counter() - t1
            # (b) the one-rank resume, in this process (no process group)
            kw = dict(smoke=True, steps=4, batch=4, seq=16, log_every=100)
            one = train("qwen3-4b", mesh_shape=(1,), ckpt_dir=os.path.join(tmp, "ck"),
                        ckpt_every=100, **kw)
        diffs = [abs(a - b) for a, b in zip(res["losses"], ref["losses"])]
        require(all(np.isfinite(res["losses"])) and max(diffs) <= MESH_LOSS_TOL,
                f"(a) sharded losses {res['losses']} against one rank's {ref['losses']}")
        upd = res["update"]
        require(upd["dd"] < TRAIN_UPDATE_TOL * upd["d1"],
                f"(a) step 0's update: dd {upd['dd']} against d1 {upd['d1']}")
        n_tok = MESH_BATCH * MESH_SEQ
        steady = statistics.median(res["ms"][1:-1] or res["ms"][1:])
        log(f"mesh: (a) {MESH_BACKEND} {MESH_SHAPE} ranks on one card: loss_total "
            f"{[round(x, 4) for x in res['losses']]}, largest difference {max(diffs):.2e}; "
            f"step 0 update dd/d1 {upd['dd'] / upd['d1']:.4f}; ms a step "
            f"{[round(x, 1) for x in res['ms']]} (median {steady:.1f} ms, "
            f"{n_tok / steady * 1e3:.1f} tokens/s); peak {res['peak_gb']:.2f} GB on rank 0; "
            f"layouts {res['placements']}")
        log(f"mesh: (a) collectives of one step on rank 0 {json.dumps(res['collectives'])}")
        b1 = res["batch1"]
        require(b1["finite"] and b1["max_abs"] <= MESH_B1_TOL,
                f"(a) batch-1 serving on the mesh against the plain path: {b1}")
        log(f"mesh: (a) batch 1 served on {MESH_SHAPE} (batch layout {b1['mesh']['layout']}): "
            f"prefill {MESH_B1_PROMPT} + {MESH_B1_STEPS} decode steps, logits max |diff| "
            f"{b1['max_abs']:.4e} <= {MESH_B1_TOL} against the plain path; prefill "
            f"{b1['mesh']['prefill_ms']:.1f} ms, decode {b1['mesh']['decode_ms']:.1f} ms a step "
            f"(plain {b1['plain']['prefill_ms']:.1f} ms, {b1['plain']['decode_ms']:.1f} ms)")
        full = res["b_full"]
        for what, got in ((f"({world}, 1)", res["b_resumed_4x1"]), ("one rank", one)):
            rel = float(np.max(np.abs(np.asarray(got) / np.asarray(full[2:]) - 1)))
            require(rel <= TRAIN_RESUME_RTOL,
                    f"(b) resumed on {what}: {got} against {full[2:]}")
            log(f"mesh: (b) launch.train {MESH_SHAPE} stopped at step 2, resumed on "
                f"{what}: {[round(x, 4) for x in got]} against {[round(x, 4) for x in full[2:]]}, "
                f"largest relative difference {rel:.2e}")
        log(f"mesh: (a)+(b) ranks {ranks_s:.1f} s")
        for arch, shape, t1, proc in dry:
            proc.wait(timeout=900)
            secs = time.perf_counter() - t1
            path = os.path.join(dry_dir, f"{arch}__{shape}__single.json")
            with open(os.path.join(dry_dir, f"{arch}__{shape}.log")) as f:
                err = f.read()
            require(proc.returncode == 0 and os.path.exists(path),
                    f"(c) dry run {arch} {shape}: {err[-2000:]}")
            with open(path) as f:
                cell = json.load(f)
            require(cell["status"] == "ok", f"(c) dry run {arch} {shape}: {cell}")
            log(f"mesh: (c) dry run {arch} {shape} single (16 x 16), done "
                f"{secs:.1f} s after it started: {json.dumps(cell)}")
    finally:
        stop_dryrun(started)
    # the main path ran in the ranks: their counts, summed; this process's
    # own (the single-rank reference and the one-rank resume) held apart
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    here = launch_counts()
    require(not any(launches.values()) and not any(here.values()),
            f"a sorter kernel launched in the mesh phase: ranks {launches}, here {here}")
    for key, name in RESULT_WRAPPERS:
        results[key]["launches_mesh"] = launches[name]
    log(f"mesh: launches of the four sorter kernels on the {len(ranks)} rank(s) of (a)+(b) "
        f"{launches}; in this process (the reference step, the one-rank resume) {here}")
    log(f"mesh: phase {time.perf_counter() - t0:.1f} s")


def start_example(name: str, *args: str) -> tuple:
    """``examples/<name> *args --device cuda`` started in a subprocess."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name), *args, "--device", "cuda"],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return name, time.perf_counter(), proc


def example_result(started: tuple) -> tuple[dict, float]:
    """A started example's last JSON line and its seconds; a non-zero
    exit or a run past EX_TIMEOUT_S fails the phase."""
    name, t0, proc = started
    try:
        out, err = proc.communicate(timeout=EX_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    secs = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"examples: {name} exited {proc.returncode}: {err[-3000:]}")
    line = [s for s in out.splitlines() if s.startswith("{")][-1]
    return json.loads(line), secs


def phase_examples(torch, results: dict) -> None:
    """14. Each ``examples/torch_*.py`` on the card, all four at once
    (see the module docstring)."""
    from repro_torch.core import external, validate
    from repro_torch.core.config import SortConfig
    from repro_torch.data import gensort

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        started = [
            start_example("torch_quickstart.py", str(EX_QUICK_RECORDS),
                          str(EX_QUICK_READERS), "--workdir", tmp),
            start_example("torch_distributed_sort_demo.py", "--records",
                          str(EX_DEMO_RECORDS), "--ranks", str(EX_DEMO_RANKS)),
            start_example("torch_serve_lm.py"),
            start_example("torch_train_lm.py", "--tiny"),
        ]
        try:
            (q, q_s), (d, d_s), (sv, sv_s), (tr, tr_s) = (example_result(e) for e in started)
        finally:
            for _, _, proc in started:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        chk = checksum_file(validate, gensort, q["input"])
        require(q["ok"] and validate.validate_file(q["output"], chk, EX_QUICK_RECORDS)["ok"],
                f"examples: the quickstart's output failed validation: {q}")
        host = os.path.join(tmp, "host.sorted")
        external.sort_file(q["input"], host, config=SortConfig(
            memory_budget_bytes=64 << 20, executor="host"))
        host_sha = sha256(host)
        require(q["sha256"] == host_sha,
                f"examples: quickstart bytes {q['sha256']} != host executor's {host_sha}")
        require(q["executor"] == "batched", f"examples: quickstart executor {q['executor']}")
        for name in ("encode_keys", "rmi_bucket", "sort_rows"):
            require(q["launches"][name] > 0,
                    f"examples: {name} was never launched on the quickstart path")
    for key, name in RESULT_WRAPPERS:
        results[key]["launches_quickstart"] = q["launches"][name]
    log(f"examples: torch_quickstart.py {EX_QUICK_RECORDS} {EX_QUICK_READERS}: validated, "
        f"sha256 == host executor's {host_sha}, executor {q['executor']}, sort "
        f"{q['seconds']:.3f} s, launches {q['launches']}; {q_s:.1f} s in all")
    require(d["ok"] and d["lost"] == 0 and sum(d["n_valid"]) == EX_DEMO_RECORDS
            and all(r["rmi_bucket"] > 0 for r in d["launches"]),
            f"examples: the distributed demo: {d}")
    log(f"examples: torch_distributed_sort_demo.py --records {EX_DEMO_RECORDS} --ranks "
        f"{EX_DEMO_RANKS} (gloo on {sorted(set(d['devices']))}): order == np.lexsort, "
        f"lost 0, per-rank load {d['n_valid']}, launches by rank {d['launches']}; "
        f"{d_s:.1f} s in all")
    require(sv["logits_finite"] and sv["repeatable"], f"examples: serving: {sv}")
    log(f"examples: torch_serve_lm.py: {sv['shape']} tokens, logits finite, "
        f"{sv['tokens_per_s']:.0f} tokens/s warm; {sv_s:.1f} s in all")
    require(tr["last_loss"] < tr["first_loss"], f"examples: training: {tr}")
    log(f"examples: torch_train_lm.py --tiny: {tr['steps']} steps, loss "
        f"{tr['first_loss']:.4f} -> {tr['last_loss']:.4f}; {tr_s:.1f} s in all")
    log(f"examples: phase {time.perf_counter() - t0:.1f} s (the four at once)")


def checksum_file(validate, gensort, path: str) -> int:
    """validate.checksum over the whole file, summed chunk by chunk (the
    checksum is a sum of per-record hashes mod 2**64)."""
    recs = gensort.read_records(path)
    total = 0
    for i in range(0, recs.shape[0], 1 << 20):
        total += validate.checksum(recs[i : i + (1 << 20)])
    return total % (1 << 64)


def start_device_trace(torch):
    """A running ``torch.profiler`` trace of the card's activity, or None
    where the profiler cannot trace it (then the device time of the main
    path is reported as not measured)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except RuntimeError as e:
        log(f"main: profiler unavailable ({e})")
        return None
    return prof


def log_device_time(prof, what: str, wall: float) -> None:
    """Stop a trace from ``start_device_trace`` and log its device time
    beside ``wall`` seconds, with the top kernels."""
    if prof is None:
        log(f"{what}: device busy share not measured")
        return
    prof.__exit__(None, None, None)
    busy, top = device_time(prof)
    log(f"{what}: device busy {busy * 1e3:.3f} ms of {wall:.3f} s wall = "
        f"{busy / wall:.4%} (torch.profiler)")
    for sec, name, count in top:
        log(f"{what}:   {sec * 1e3:9.3f} ms  x{count:<4d} {name[:90]}")


def device_time(prof) -> tuple[float, list]:
    """Seconds of device activity in the trace, and the top entries: the
    CUDA-side events (kernels, copies, fills) summed by name, read from
    the raw trace (``key_averages`` builds a Python event a launch, which
    takes minutes at the LM paths' ~10^6 launches)."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            ns, count = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), count + 1)
    rows = sorted(((ns / 1e9, name, count) for name, (ns, count) in by_name.items()),
                  reverse=True)
    return sum(r[0] for r in rows), rows[:8]


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import external, manifest, validate
        from repro_torch.core.config import SortConfig
        from repro_torch.data import gensort
        from repro_torch.kernels import build, ops
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3

    t_start = time.perf_counter()
    # 1. build
    build.library()
    info = build.build_info
    log(f"build: {'compiled' if info['compiled'] else 'loaded the cached'} "
        f"{info['path']} in {info['seconds']:.1f} s")
    for src, lines in info["ptxas"].items():
        for line in lines:
            log(f"build:   {src}: {line}")

    # 2. kernels; 2b. the full-key sort
    results = phase_kernels(torch, torch.device("cuda"))
    phase_full_key(torch, results)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 3. main path
        inp = os.path.join(tmp, "skewed.bin")
        out = os.path.join(tmp, "skewed.sorted")
        t0 = time.perf_counter()
        gensort.write_file(inp, MAIN_RECORDS, skewed=True, seed=0)
        refsum = checksum_file(validate, gensort, inp)
        log(f"main: wrote {MAIN_RECORDS} skewed records in "
            f"{time.perf_counter() - t0:.1f} s")
        prof = start_device_trace(torch)
        ops.reset_launches()
        stats = external.sort_file(inp, out, config=SortConfig(manifest=True))
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in ops.KERNEL_WRAPPERS}
        if prof is not None:
            prof.__exit__(None, None, None)
        res = validate.validate_file(out, refsum, MAIN_RECORDS)
        require(res["ok"], f"1 GB sort failed validation: {res}")
        require(stats.executor == "batched", f"executor {stats.executor}")
        for name in ("encode_keys", "rmi_bucket", "sort_rows", "bucket_histogram"):
            require(launches[name] > 0,
                    f"{name} was never launched on the main path")
        m = manifest.load(stats.manifest_path)
        require(m.n_records == MAIN_RECORDS
                and int(m.part_counts.sum()) == MAIN_RECORDS
                and m.model_hash == manifest.model_hash(m.model),
                "the 1 GB sort's manifest does not load back")
        phases = {k: round(v, 3) for k, v in stats.phase_seconds.items()}
        walls = {k: round(v, 3) for k, v in stats.phase_wall_seconds.items()}
        log(f"main: sort_file 1 GB ok in {stats.wall_seconds:.2f} s = "
            f"{stats.rate_mb_s():.1f} MB/s; planner {stats.planner_decision}, "
            f"{len(stats.partition_counts)} partitions, "
            f"device_dispatches {stats.device_dispatches}, "
            f"batch_occupancy {stats.batch_occupancy:.4f}, "
            f"fallbacks {stats.fallbacks}, shapes {stats.jit_compiles}, "
            f"launches {launches}")
        log(f"main: manifest {stats.manifest_path} loaded back: "
            f"{m.n_partitions} partitions, error band -{m.err_lo}/+{m.err_hi}")
        log(f"main: phase busy seconds {json.dumps(phases)}")
        log(f"main: phase wall seconds {json.dumps(walls)}")
        if prof is None:
            log("main: device busy share not measured")
        else:
            busy, top = device_time(prof)
            log(f"main: device busy {busy:.4f} s of {stats.wall_seconds:.2f} s "
                f"wall = {busy / stats.wall_seconds:.4%} (torch.profiler)")
            for sec, name, count in top:
                log(f"main:   {sec * 1e3:9.3f} ms  x{count:<4d} {name[:90]}")
        for key, name in RESULT_WRAPPERS:
            results[key]["launches"] = launches[name]

        # 10. the mesh-scale sort, first on the main phase's file
        phase_distributed(torch, inp, refsum, sha256(out), MAIN_RECORDS, tmp,
                          results)
        os.unlink(inp)

        # 4. serve the sorted file
        phase_serve(torch, out, tmp)
        os.unlink(out)

        # 5. byte identity: the card's grid path == the host executor
        inp = os.path.join(tmp, "uniform.bin")
        gensort.write_file(inp, IDENTITY_RECORDS, seed=7)
        refsum = checksum_file(validate, gensort, inp)
        shas = {}
        for name, cfg in (
            ("cuda", SortConfig()),
            ("host", SortConfig(executor="host")),
        ):
            o = os.path.join(tmp, f"{name}.sorted")
            st = external.sort_file(inp, o, config=cfg)
            require(validate.validate_file(o, refsum, IDENTITY_RECORDS)["ok"],
                    f"{name} output failed validation")
            shas[name] = (sha256(o), st.executor)
        require(shas["cuda"][0] == shas["host"][0], f"outputs differ: {shas}")
        require(shas["cuda"][1] == "batched", f"card run used {shas['cuda'][1]}")
        log(f"bytes: 1M uniform records, card == host, sha256 {shas['cuda'][0]}")
        want = shas["host"][0]
        for name in shas:
            os.unlink(os.path.join(tmp, f"{name}.sorted"))
        phase_per_partition(torch, inp, refsum, want, tmp)

        # 6. the model cache; 7. the mergesort baseline
        phase_cache(torch, inp, want, tmp)
        phase_mergesort(inp, want, tmp)
        os.unlink(inp)

        # 8.-9. the merge-free operators
        phase_ops_lines(torch, tmp)
        phase_ops_fixed(torch, tmp)

    # 11. the LM serving path; 12. the LM training path
    phase_lm(torch, results)
    # 13. (c)'s dry-run cells run on the host's cores beside phases 12 and 13
    dry = start_dryrun()
    try:
        phase_train(torch, results)
        # 13. the sharded LM step
        phase_mesh(torch, results, dry)
    finally:
        stop_dryrun(dry)
    # 14. the examples
    phase_examples(torch, results)
    log(f"smoke: every phase ok in {time.perf_counter() - t_start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches",
            "launches_distributed", "launches_lm", "launches_train", "launches_mesh",
            "launches_quickstart", "launches_full_key", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: results[n][k] for k in keys} for n, _ in RESULT_WRAPPERS]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
