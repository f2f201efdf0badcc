#!/usr/bin/env python3
"""Where the row sorter's time goes, and why its compare is written as
it is: ``src/repro_torch/csrc/bitonic.cu`` against variants of itself,
on one CUDA card.

Each variant is the committed source with one change, built with the
port's nvcc flags into its own library:

- ``kernel``       — the source as committed;
- ``u64_compare``  — the slot compare as ``ka > kb || (ka == kb && va >
  vb)`` on a packed u64 key (the earlier design's form) in place of the
  96-bit borrow chain;
- ``mask_select``  — the exchange driven by an all-ones mask and
  ``(a & ~m) | (b & m)`` in place of predicated selects;
- ``imad_select``  — the in-thread exchange as ``a + d * s`` integer
  multiply-adds, moving work off the integer ALU onto the FMA pipe;
- ``no_sort``      — the loads and stores only (the memory part);
- ``no_memory``    — the network only: no device loads, and a store
  only under a condition that never holds (the compute part).

For each it prints the registers and spills of the one-warp-a-row
kernel (E = 32, the main path's), its SASS instruction count by opcode
(``cuobjdump``), and its cold time (CUDA events, median of 20 after a
256 MB write that evicts the L2) at three row shapes, variants run in
turns forward then backward; ``(x)`` marks a variant whose output is not
the plain version's (the two partial ones).  Run from the repository
root on a machine with the card and the CUDA toolkit:

    python3 experiments/bitonic_variants.py
"""

import collections
import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import bitonic, build  # noqa: E402

SHAPES = ((8192, 1024), (16384, 512), (2048, 4096))
WARP_KERNEL = "ILi32ELb0ELi128E"  # bitonic_kernel<32, false, 128>


def _between(src, start, end):
    return src[src.index(start):src.index(end)]


def variants(src: str) -> dict[str, list[tuple[str, str]]]:
    """Each variant as (old, new) replacements on the committed source."""
    greater_body = _between(src, "  unsigned borrow;", "// slots a < b")
    exchange_body = _between(src, "  const bool sw = greater(", "// keep the partner")
    keep_body = _between(src, "  // equal slots are the same slot", "// levels k = 2")
    load = "  load_rows(hi, lo, val, base, n, sh, sl, sv, i0, step, vec);\n"
    store = "  store_rows(hi_out, lo_out, val_out, base, n, sh, sl, sv, i0, step, vec);\n"
    network = _between(src, "  const int first = t * E;\n", "  if (ROW_BLOCK) __syncthreads(); else __syncwarp();\n#pragma unroll")
    # the borrow chain's all-ones word itself, not a predicate made of it
    greater = _between(src, "__device__ __forceinline__ bool greater(", "// slots a < b")
    mask = greater.replace("bool greater(", "unsigned gmask(").replace(
        "return borrow != 0;", "return borrow;"
    ) + "// slots a < b"
    return {
        "kernel": [],
        "u64_compare": [(greater_body, (
            "  const unsigned long long ka = ((unsigned long long)ha << 32) | la;\n"
            "  const unsigned long long kb = ((unsigned long long)hb << 32) | lb;\n"
            "  return ka > kb || (ka == kb && va > vb);\n}\n\n"
        ))],
        "mask_select": [("// slots a < b", mask), (exchange_body, (
            "  const unsigned m = gmask(h[a], l[a], v[a], h[b], l[b], v[b]) ^ (asc ? 0u : kFull);\n"
            "  const unsigned ha = h[a], la = l[a], va = v[a];\n"
            "  h[a] = (ha & ~m) | (h[b] & m); h[b] = (h[b] & ~m) | (ha & m);\n"
            "  l[a] = (la & ~m) | (l[b] & m); l[b] = (l[b] & ~m) | (la & m);\n"
            "  v[a] = (va & ~m) | (v[b] & m); v[b] = (v[b] & ~m) | (va & m);\n}\n\n"
        )), (keep_body, (
            "  const unsigned m = gmask(h, l, v, ph, pl, pv) ^ (keep_min ? 0u : kFull);\n"
            "  h = (h & ~m) | (ph & m); l = (l & ~m) | (pl & m); v = (v & ~m) | (pv & m);\n}\n\n"
        ))],
        "imad_select": [("// slots a < b", mask), (exchange_body, (
            "  const unsigned m = gmask(h[a], l[a], v[a], h[b], l[b], v[b]) ^ (asc ? 0u : kFull);\n"
            "  const unsigned s = m & 1u;\n"
            "#define MADX(x) { const unsigned d = x[b] - x[a]; unsigned na, nb; \\\n"
            "    asm(\"mad.lo.u32 %0, %1, %2, %3;\" : \"=r\"(na) : \"r\"(d), \"r\"(s), \"r\"(x[a])); \\\n"
            "    asm(\"mad.lo.u32 %0, %1, %2, %3;\" : \"=r\"(nb) : \"r\"(d), \"r\"(m), \"r\"(x[b])); \\\n"
            "    x[a] = na; x[b] = nb; }\n"
            "  MADX(h) MADX(l) MADX(v)\n#undef MADX\n}\n\n"
        ))],
        "no_sort": [(network, "")],
        "no_memory": [(load, ""), (store, (
            "  if (sv[pad(i0)] == 0x12345678u && sh[pad(i0)] == 0x9abcdefu)\n  " + store
        ))],
    }


def compile_all(tmp: str) -> dict:
    src = open(os.path.join(build.CSRC, "bitonic.cu")).read()
    nvcc = build._nvcc()
    procs = {}
    for name, edits in variants(src).items():
        s = src
        for old, new in edits:
            if old not in s:
                raise RuntimeError(f"{name}: anchor not found in bitonic.cu")
            s = s.replace(old, new, 1)
        cu, so = os.path.join(tmp, name + ".cu"), os.path.join(tmp, name + ".so")
        with open(cu, "w") as f:
            f.write(s)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name} failed to build:\n{log}")
        lines = log.splitlines()
        at = next(i for i, ln in enumerate(lines) if WARP_KERNEL in ln)
        res = [ln.split(":", 1)[-1].strip() for ln in lines[at + 1:at + 4]
               if "spill" in ln or "registers" in ln]
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", so],
            capture_output=True, text=True, check=True,
        ).stdout
        body = re.search(
            rf"Function : \S*{WARP_KERNEL}\S*\n(.*?)(?=\n\s*Function :|\Z)", sass, re.S
        ).group(1)
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body
            )
        )
        print(f"{name}: {'; '.join(res)}; SASS {sum(ops.values())} "
              f"instructions, {dict(ops.most_common(8))}", flush=True)
        lib = ctypes.CDLL(so)
        fn = lib.repro_sort_rows
        fn.restype = ctypes.c_int
        fn.argtypes = build._SIGNATURES["repro_sort_rows"][1]
        libs[name] = fn
    return libs


def cold_ms(fn, reps: int = 20) -> float:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> int:
    if not torch.cuda.is_available():
        print("bitonic_variants: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all(tmp)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        for r, c in SHAPES:
            hi = torch.randint(0, 1 << 32, (r, c), device="cuda", generator=gen)
            lo = torch.randint(0, 1 << 32, (r, c), device="cuda", generator=gen)
            hi[:, ::2] %= 4  # ties on hi, so lo and val decide
            val = torch.randint(-(2**31), 2**31 - 1, (r, c), device="cuda",
                                generator=gen, dtype=torch.int32)
            want = bitonic.sort_rows_plain(hi, lo, val)
            geo = bitonic.launch_geometry(c)
            times = collections.defaultdict(list)
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    out = [torch.empty_like(t) for t in (hi, lo, val)]
                    ptrs = [t.data_ptr() for t in (hi, lo, val, *out)]
                    launch = lambda: libs[name](*ptrs, r, c, *geo, stream)  # noqa: E731
                    build.check(launch(), name)
                    torch.cuda.synchronize()
                    ok = all(torch.equal(a, b) for a, b in zip(out, want))
                    times[name].append(f"{cold_ms(launch):.4f}{'' if ok else '(x)'}")
            print(f"({r}, {c}): " + ", ".join(
                f"{n} {'/'.join(t)} ms" for n, t in times.items()
            ), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
