#!/usr/bin/env python3
"""Several checkouts of this repo timed against each other on one CUDA card,
a process per tree (each imports pgrc_tpu_torch from its tree and builds
that tree's kernels).

    python3 ab.py --what kmer TREE [TREE ...]
    python3 ab.py --what sweep TREE [TREE ...]
    python3 ab.py --what encode [--pairs 5] [--reads 2000000] [--encodes 2] TREE_A TREE_B

Each TREE is the root of a checkout. Without a CUDA card it exits 2.

--what kmer: kernels B (index_kmer_hash) and C (probe_kmer_hash) with
chip_smoke.py's timer, one process per TREE in the order given (`old new
new old` interleaves two trees). The process takes chip_smoke.py from beside
this script: its `cuda_ms` (the device time of each call, with the L2 cache
evicted before it), `bound` and `hash_ops`. On random lanes it then times,
each against its tree's plain version first (bit-equal required):
  B at chip_smoke's three shapes: the main path's 5M-symbol pg (m 1.25M,
    k 32); the second index block of a 300M-symbol pg (k 37); the last
    block of a 2.3G-symbol pg (int64 positions, k 40); k1 4 in all;
  C at 2^18 rows of 8 lanes, the 23 offsets 0, 3, .., 66 of a 100-symbol
    read, k 32.
A tree whose kernels write join keys (`kmer_hash.index_keys` exists) is
called with its key buffers. A tree whose kernels write bare hashes is
called as its matcher called them; its C is also timed through the
kernel's entry point alone, since that wrapper read the offsets' minimum
and maximum from the card on every call. Prints one `[ab]` line per kernel
and tree: the time, the bound (chip_smoke.bound over the bytes that tree's
kernel moves) and the share.

--what sweep: kernels G (sweep_full_hashes) and H (sweep_compact) the same
way, one process per TREE, with chip_smoke.py's `check_hashes` and
`check_compact` (10 launches bit-equal to the tree's plain version, then
the device time beside the plain version's and chip_smoke's bound), on
random tables made on the card:
  G in its init form (with the key) at SE 2M's first init, 1,760,000 rows
    of L 100 without N, and at 2^18 rows with N;
  H at SE 2M's first compaction, 1,760,000 rows of L 100 without N, 81%
    kept, and at 2^18 rows with N, 58% kept (chip_smoke's 2^18 table).
The `[kernel]` lines name the tree.

--what encode: SE encode walls of two trees in alternating pairs. The input
is bench.py's SE 2M file (`synth_fastq(src, 2_000_000, 100, 5_000_000,
seed=9)`, made once with TREE_A's generator, in a temporary directory of
TREE_A). Pair k runs TREE_A then TREE_B when k is even and TREE_B then
TREE_A when it is odd: one warm-up compress through the port's CLI on the
card, then `--encodes` timed ones (host clock around `cli.main`, after
`torch.cuda.synchronize()`), each with its stage times and its peak device
memory (torch.cuda.max_memory_allocated from a reset before it). Prints one
`[ab]` line per process and, last, one JSON object with every wall and peak
by tree.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
L, K1, REPS = 100, 4, 20
B_SHAPES = (  # label, pg symbols, k, lane_off (chip_smoke's main path and phase 6)
    ("main path", 5_000_000, 32, 0),
    ("300M block", 300_000_007, 37, 1 << 24),
    ("2.3G block, int64", 2_300_000_003, 40, 1 << 27),
)
BLOCK_LANES = (1 << 26) * K1 // 16   # lanes of one 2^26-entry index block
WIDE_FROM = 0x7FFF0000               # the matcher's wide probe: pg_len > WIDE_FROM - L
C_ROWS, C_LANES, C_K = 1 << 18, 8, 32
C_OFFS = tuple(range(0, L - C_K + 1, 3))
# (label, rows, N, each side active with this probability) of --what sweep:
# SE 2M's first init and compaction (81% of its rows kept) and chip_smoke's
# 2^18 table
SE2M_ROWS = 1_760_000
SWEEP_SHAPES = (
    ("SE 2M's first init / compaction shape", SE2M_ROWS, False, 1 - 0.19 ** 0.5),
    ("2^18 rows with N", 1 << 18, True, 0.35),
)


def load_timer():
    """chip_smoke.py from beside this script (not the tree's own copy)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timer",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rand_lanes(shape, dev):
    return torch.randint(-(1 << 31), (1 << 31) - 1, shape, dtype=torch.int32, device=dev)


def import_from(tree: str) -> None:
    """Put `tree` first on the path and check that pgrc_tpu_torch comes from it."""
    sys.path.insert(0, tree)
    import pgrc_tpu_torch

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(pgrc_tpu_torch.__file__)))
    if pkg != tree:
        raise SystemExit(f"pgrc_tpu_torch came from {pkg}, not {tree}")


def kmer_tree(tree: str) -> None:
    import_from(tree)
    from pgrc_tpu_torch import kernels
    from pgrc_tpu_torch.kernels import kmer_hash as kh

    cs = load_timer()
    dev = torch.device("cuda")
    key_form = hasattr(kh, "index_keys")
    form = "join keys" if key_form else "bare hashes"
    kernels.build.lib()

    def report(name, note, fn, plain, nbytes, ops):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = cs.max_abs_err(got if isinstance(got, tuple) else (got,),
                             want if isinstance(want, tuple) else (want,))
        if err:
            raise SystemExit(f"{tree}: {name} {note} differs from its plain version")
        del got, want
        ms = cs.cuda_ms(fn, REPS)
        bound_ms, by = cs.bound(nbytes, ops)
        print(f"[ab] {tree} ({form}) {name} {note}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({by}: {nbytes} B), share {bound_ms / ms:.3f}", flush=True)

    for label, pg_len, k, lane_off in B_SHAPES:
        n_lanes = -(-pg_len // 16)
        lanes = rand_lanes((n_lanes + 1,), dev)
        lanes[-1] = 0
        m = (min(lane_off + BLOCK_LANES, n_lanes) - lane_off) * 16 // K1
        wide = pg_len > WIDE_FROM - L
        pos_bytes = 8 if wide else 4
        args = (lanes, k, K1, pg_len, m, lane_off, wide)
        lanes_read = (m * K1 // 16 + k // 16 + 2) * 4
        if key_form:
            key = torch.empty((m,), dtype=torch.int64, device=dev)
            ipos = torch.empty((m,), dtype=torch.int64 if wide else torch.int32, device=dev)
            fn, out_bytes = (lambda: kh.index_kmer_hash(*args, key=key, ipos=ipos)), 8 + pos_bytes
        else:
            fn, out_bytes = (lambda: kh.index_kmer_hash(*args)), 4 + pos_bytes
        report("B index_kmer_hash", f"{label}, m={m} k={k}", fn,
               lambda: kh.index_kmer_hash_plain(*args), lanes_read + m * out_bytes,
               cs.hash_ops(m * K1 + k, m))
        del lanes, fn
        if key_form:
            del key, ipos
        torch.cuda.empty_cache()

    lanes = rand_lanes((C_ROWS, C_LANES), dev)
    S = len(C_OFFS)
    note = f"R={C_ROWS} S={S} k={C_K}"
    ops = cs.hash_ops(C_ROWS * (max(C_OFFS) + C_K), C_ROWS * S)
    in_bytes = lanes.numel() * 4 + S * 4
    if key_form:
        out = torch.empty((C_ROWS * S,), dtype=torch.int64, device=dev)
        report("C probe_kmer_hash", note, lambda: kh.probe_kmer_hash(lanes, C_OFFS, C_K, out=out),
               lambda: kh.probe_kmer_hash_plain(lanes, C_OFFS, C_K), in_bytes + 8 * C_ROWS * S, ops)
    else:
        offs_t = torch.tensor(C_OFFS, dtype=torch.int32, device=dev)
        out = torch.empty((C_ROWS, S), dtype=torch.int32, device=dev)
        plain = lambda: kh.probe_kmer_hash_plain(lanes, offs_t, C_K)
        report("C probe_kmer_hash", note + ", wrapper", lambda: kh.probe_kmer_hash(lanes, offs_t, C_K),
               plain, in_bytes + 4 * C_ROWS * S, ops)

        def entry_point():
            kernels.launch("pgrc_probe_kmer_hash", dev, kernels.ptr(lanes), C_ROWS, C_LANES,
                           kernels.ptr(offs_t), S, C_K, kernels.ptr(out))
            return out

        report("C probe_kmer_hash", note + ", entry point alone", entry_point, plain,
               in_bytes + 4 * C_ROWS * S, ops)


def sweep_tree(tree: str) -> None:
    import_from(tree)
    from pgrc_tpu_torch import kernels

    cs = load_timer()
    dev = torch.device("cuda")
    kernels.build.lib()
    gen = torch.Generator(device=dev).manual_seed(7)
    words = lambda n, w: torch.randint(-(1 << 31), (1 << 31) - 1, (n, w), dtype=torch.int32,
                                       device=dev, generator=gen)
    for label, n, with_n, act in SWEEP_SHAPES:
        lanes = words(n, (L + 15) // 16 + 1)
        nmask = words(n, (L + 31) // 32 + 1) if with_n else None
        cs.check_hashes((lanes, nmask, L, True), f"{tree}: {label}, n={n} N={with_n} key=True",
                        REPS)
        hashes = [torch.randint(-(1 << 63), (1 << 63) - 1, (n,), dtype=torch.int64, device=dev,
                                generator=gen) for _ in range(4)]
        flags = [torch.rand((n,), device=dev, generator=gen) < act for _ in range(2)]
        ids = torch.arange(0, 3 * n, 3, dtype=torch.int32, device=dev)
        table = (lanes, nmask, ids, *hashes, *flags)
        kept = int((flags[0] | flags[1]).sum())
        cs.check_compact(table, f"{tree}: {label}, n={n} N={with_n}, {kept} kept", REPS)
        del lanes, nmask, hashes, flags, ids, table
        torch.cuda.empty_cache()


def encode_tree(tree: str, src: str, encodes: int) -> None:
    """One warm-up and `encodes` timed SE compresses of src on the card."""
    import_from(tree)
    from pgrc_tpu_torch import cli
    from pgrc_tpu_torch.archive import encoder

    out = os.path.join(os.path.dirname(src), "out.pgtc")
    stages = []
    real = encoder.encode

    def spy(params, *a, **k):
        stats = real(params, *a, **k)
        stages.append({key: round(v, 3) for key, v in stats.stage_times.items()})
        return stats

    encoder.encode = spy
    walls, peaks = [], []
    for _ in range(encodes + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        if cli.main(["--device", "cuda", "-i", src, out]) != 0:
            raise SystemExit(f"{tree}: compress failed")
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**20)
    print("RESULT " + json.dumps({"walls": walls[1:], "peak_mib": peaks[1:],
                                  "stages": stages[1:]}), flush=True)


def encode_ab(trees: list, pairs: int, reads: int, encodes: int) -> int:
    work = tempfile.mkdtemp(prefix="chip_smoke_ab_", dir=trees[0])
    try:
        sys.path.insert(0, trees[0])
        from pgrc_tpu_torch import synth

        src = os.path.join(work, "se.fastq")
        synth.synth_fastq(src, reads, L, reads * 5 // 2, seed=9)
        walls, peaks = {t: [] for t in trees}, {t: [] for t in trees}
        for k in range(pairs):
            for tree in (trees if k % 2 == 0 else trees[::-1]):
                run = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--what", "encode", "--one",
                     "--src", src, "--encodes", str(encodes), tree],
                    capture_output=True, text=True)
                line = [x for x in run.stdout.splitlines() if x.startswith("RESULT ")]
                if run.returncode != 0 or not line:
                    print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
                    return 1
                res = json.loads(line[0][len("RESULT "):])
                walls[tree] += res["walls"]
                peaks[tree] += res["peak_mib"]
                print(f"[ab] pair {k} {os.path.relpath(tree)}: walls "
                      f"{[round(w, 3) for w in res['walls']]} s, peak device memory "
                      f"{[round(p) for p in res['peak_mib']]} MiB, stages {res['stages']}",
                      flush=True)
        print(json.dumps({"device": torch.cuda.get_device_name(0), "reads": reads,
                          "walls": {os.path.relpath(t): w for t, w in walls.items()},
                          "peak_mib": {os.path.relpath(t): p for t, p in peaks.items()}}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--what", choices=("kmer", "sweep", "encode"), required=True)
    ap.add_argument("--pairs", type=int, default=5, help="encode: alternating pairs")
    ap.add_argument("--reads", type=int, default=2_000_000, help="encode: SE reads")
    ap.add_argument("--encodes", type=int, default=2, help="encode: timed encodes a process")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab: no CUDA device", file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in args.trees]
    if args.one:
        if args.what == "kmer":
            kmer_tree(trees[0])
        elif args.what == "sweep":
            sweep_tree(trees[0])
        else:
            encode_tree(trees[0], args.src, args.encodes)
        return 0
    if args.what == "encode":
        if len(trees) != 2:
            ap.error("--what encode takes two trees")
        return encode_ab(trees, args.pairs, args.reads, args.encodes)
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--what", args.what, "--one",
                        tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
