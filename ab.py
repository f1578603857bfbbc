#!/usr/bin/env python3
"""Several checkouts of this repo timed against each other on one CUDA card,
a process per tree (each imports pgrc_tpu_torch from its tree and builds
that tree's kernels).

    python3 ab.py --what kmer TREE [TREE ...]
    python3 ab.py --what sweep TREE [TREE ...]
    python3 ab.py --what verify TREE [TREE ...]
    python3 ab.py --what strand TREE [TREE ...]
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

--what sweep: kernels G (sweep_full_hashes), G2 (sweep_init_links) and H
(sweep_compact) the same way, one process per TREE, with chip_smoke.py's
`check_hashes` and `check_compact` (10 launches bit-equal to the tree's
plain version, then the device time beside the plain version's and
chip_smoke's bound), on random tables made on the card:
  G in its init form (with the key) at SE 2M's first init, 1,760,000 rows
    of L 100 without N, a share SE2M_DUP of them copies of other rows, and
    at 2^18 rows with N;
  G2 on G's key of those rows, sorted stably (as the init does), as the
    init calls it (the rows' unlinked state and the links) and, in a tree
    with G2's fill kernel (`link_defaults`), kernel G2 alone patching a
    filled state; and G + G2;
  H at SE 2M's first compaction, 1,760,000 rows of L 100 without N, 81%
    kept, and at 2^18 rows with N, 58% kept (chip_smoke's 2^18 table).
The `[kernel]` lines name the tree.

--what verify: kernel A (verify_best) the same way, on random pg lanes and
read lanes made on the card and anchors made by chip_smoke's `anchors`
(a share of the slots in range, the rest without an anchor, before the pg
or past its last start), at VERIFY_SHAPES: chip_smoke's synthetic rows (R
2^18, S 23, n_verify 6 and 1, a 5M-symbol pg, 70% in range), its int64
rows (R 2^18, S 21, a 2.3G-symbol pg, starts from 2^31) and SE 2M's first
probe (its R, S, pg length and share of slots in range, 18.3%, from a
chip_smoke.py run on an H100). A tree
whose A takes the anchors (`verify.probe_starts_plain` exists) is timed
as the matcher calls it; a tree whose A takes starts and a mask is timed
with the probe's epilogue before it (matcher.py's anchors-to-starts
lines, ~8 elementwise launches) and alone. Each against the plain
composition (the epilogue, then the tree's `verify_best_plain`), bit-equal.

--what strand: the matcher's strand rows the same way, at STRAND_SHAPES:
SE 2M's strand prep (its 845,073 reads of L 100, without an N mask, as
the encoder's matcher gets them, and with N in 3% of the symbols) and a
take of a seeded half of those reads (sorted, as pass 2 takes them), on
random reads packed on the host and uploaded. A tree with kernel I
(`kernels/strand_rows.py`) is timed as the matcher calls it, against its
plain version (bit-equal) and beside one torch.index_select of the same
2R rows for the take; a tree without it is timed as its matcher ran: the
prep as `revcomp_lanes` and a `torch.cat`, the take as `torch.index_select`
from the prep's rows.

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
# the share of SE 2M's first-init rows made copies of other rows for G2,
# so that its share of tied positions is about SE 2M's (chip_smoke.py
# prints it)
SE2M_DUP = 0.039
# (label, pg symbols, rows, probe k, n_verify, wide, first start, share of
# slots in range) of --what verify
VERIFY_SHAPES = (
    ("chip_smoke's synthetic rows", 5_000_000, 1 << 18, 32, 6, False, 0, 0.7),
    ("chip_smoke's synthetic rows, n_verify 1", 5_000_000, 1 << 18, 32, 1, False, 0, 0.7),
    ("chip_smoke's int64 rows", 2_300_000_003, 1 << 18, 40, 6, True, 1 << 31, 0.7),
    ("SE 2M's first probe", 10_781_184, 1_690_146, 32, 6, False, 0, 0.183),
)


# (label, reads, N in this share of the symbols, take this share of the
# reads) of --what strand: SE 2M's strand prep (chip_smoke.py's capture)
STRAND_SHAPES = (
    ("SE 2M's strand prep", 845_073, 0.0, None),
    ("SE 2M's reads with N in 3%", 845_073, 0.03, None),
    ("a take of half of SE 2M's reads", 845_073, 0.0, 0.5),
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
    from pgrc_tpu_torch.kernels import sweep_init as ki

    for label, n, with_n, act in SWEEP_SHAPES:
        lanes = words(n, (L + 15) // 16 + 1)
        if not with_n:
            dup = torch.nonzero(torch.rand((n,), device=dev, generator=gen) < SE2M_DUP)[:, 0]
            lanes[dup] = lanes[torch.randint(0, n, (dup.numel(),), device=dev, generator=gen)]
        nmask = words(n, (L + 31) // 32 + 1) if with_n else None
        cs.check_hashes((lanes, nmask, L, True), f"{tree}: {label}, n={n} N={with_n} key=True",
                        REPS)
        if not with_n:
            links_tree(tree, cs, ki, lanes, f"{label}, n={n}")
        hashes = [torch.randint(-(1 << 63), (1 << 63) - 1, (n,), dtype=torch.int64, device=dev,
                                generator=gen) for _ in range(4)]
        flags = [torch.rand((n,), device=dev, generator=gen) < act for _ in range(2)]
        ids = torch.arange(0, 3 * n, 3, dtype=torch.int32, device=dev)
        table = (lanes, nmask, ids, *hashes, *flags)
        kept = int((flags[0] | flags[1]).sum())
        cs.check_compact(table, f"{tree}: {label}, n={n} N={with_n}, {kept} kept", REPS)
        del lanes, nmask, hashes, flags, ids, table
        torch.cuda.empty_cache()


def links_tree(tree, cs, ki, lanes, label) -> None:
    """G2 and G + G2 on `lanes` (no N) of one tree."""
    n = lanes.shape[0]
    h0, h0b, key = ki.sweep_full_hashes(lanes, None, L, True)
    ks, sidx = torch.sort(key, stable=True)
    del h0, key
    # a tree with G2's fill kernel: the init fills the rows' unlinked state,
    # then G2 patches it
    filled = hasattr(ki, "link_defaults")
    if filled:
        g2 = lambda: ki.sweep_init_links(ks, sidx, h0b, L, ki.link_defaults(n, lanes.device))
        want = ki.sweep_init_links_plain(ks, sidx, h0b, L, ki.link_defaults_plain(n, lanes.device))
    else:
        g2 = lambda: ki.sweep_init_links(ks, sidx, h0b, L)
        want = ki.sweep_init_links_plain(ks, sidx, h0b, L)
    err = max(cs.max_abs_err(g2(), want) for _ in range(cs.CHECK_LAUNCHES))
    if err:
        raise SystemExit(f"{tree}: G2 {label} differs from its plain version")
    nbytes, ops, n_tied = cs.links_work(ks, sidx, h0b, want[0], want[3])
    g_bytes, g_ops = cs.hashes_work(lanes, None, L, True)
    del want

    def both():
        ki.sweep_full_hashes(lanes, None, L, True)
        return g2()

    # G2 as the init calls it writes every row's unlinked state (10 bytes a
    # row) and the links; a tree with the fill is also timed patching a
    # filled state alone (kernel G2 without its fill)
    runs = [("G2 sweep_init_links", g2, nbytes + 10 * n, ops),
            ("G + G2", both, g_bytes + nbytes + 10 * n, g_ops + ops)]
    if filled:
        mine = ki.link_defaults(n, lanes.device)
        runs.insert(0, ("G2 kernel alone (patching a filled state)",
                        lambda: ki.sweep_init_links(ks, sidx, h0b, L, mine), nbytes, ops))
    for name, fn, b, o in runs:
        ms = cs.cuda_ms(fn, REPS)
        bound_ms, by = cs.bound(b, o)
        print(f"[ab] {tree} {name} {label}, {n_tied} tied positions ({n_tied / n:.4f}): "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: {b} B), share {bound_ms / ms:.3f}",
              flush=True)


def verify_tree(tree: str) -> None:
    import_from(tree)
    import numpy as np

    from pgrc_tpu_torch import kernels
    from pgrc_tpu_torch.align.matcher import probe_offsets
    from pgrc_tpu_torch.kernels import kmer_hash as kh
    from pgrc_tpu_torch.kernels import verify

    cs = load_timer()
    dev = torch.device("cuda")
    kernels.build.lib()
    takes_anchors = hasattr(verify, "probe_starts_plain")
    rng = np.random.default_rng(11)
    for label, pg_len, R, k, nv, wide, lo, frac in VERIFY_SHAPES:
        pg_lanes = rand_lanes((-(-pg_len // 16) + 1,), dev)
        pg_lanes[-1] = 0
        lanes = rand_lanes((R, (L + 15) // 16 + 1), dev)
        offs = probe_offsets(L, k, 3)
        res = torch.from_numpy(cs.anchors(rng, R, offs, pg_len, L, frac, lo=lo)).to(dev)
        max_mis = 33
        args = (lanes, res, offs, pg_lanes, pg_len, L, max_mis, nv, wide)

        def epilogue():
            st = res - 1 - kh.offsets_tensor(offs, dev).to(torch.int64)[None, :]
            in_range = (res > 0) & (st >= 0) & (st <= pg_len - L)
            return (st if wide else st.to(torch.int32)), in_range

        plain = lambda: verify.verify_best_plain(lanes, *epilogue(), pg_lanes,
                                                 max(pg_len - L, 0), L, max_mis, nv)
        if takes_anchors:
            runs = (("A", lambda: verify.verify_best(*args)),)
        else:
            start_all, in_range = epilogue()
            runs = (("A + epilogue", lambda: verify.verify_best(
                        lanes, *epilogue(), pg_lanes, max(pg_len - L, 0), L, max_mis, nv)),
                    ("A alone", lambda: verify.verify_best(
                        lanes, start_all, in_range, pg_lanes, max(pg_len - L, 0), L, max_mis,
                        nv)))
        want = plain()
        nbytes, ops = cs.verify_work(*args)
        bound_ms, by = cs.bound(nbytes, ops)
        note = (f"{label}: R={R} S={len(offs)} pg {pg_len} n_verify={nv} "
                f"{'int64' if wide else 'int32'}")
        for name, fn in runs:
            err = max(cs.max_abs_err(fn(), want) for _ in range(cs.CHECK_LAUNCHES))
            if err:
                raise SystemExit(f"{tree}: verify_best {name} {note} differs from its plain "
                                 f"version")
            ms = cs.cuda_ms(fn, REPS)
            print(f"[ab] {tree} verify_best {name} {note}: {ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({by}: {nbytes} B of the anchors' function), share {bound_ms / ms:.3f}",
                  flush=True)
        del pg_lanes, lanes, res, want, runs
        if not takes_anchors:
            del start_all, in_range
        torch.cuda.empty_cache()


def strand_tree(tree: str) -> None:
    import_from(tree)
    import numpy as np

    from pgrc_tpu_torch import kernels, state
    from pgrc_tpu_torch.core import packed

    cs = load_timer()
    dev = torch.device("cuda")
    kernels.build.lib()
    has_i = importlib.util.find_spec("pgrc_tpu_torch.kernels.strand_rows") is not None
    rng = np.random.default_rng(13)
    for label, n, n_frac, take in STRAND_SHAPES:
        codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
        if n_frac:
            codes[rng.random(codes.shape) < n_frac] = 4
        lanes, nmask = state.lanes_to_device(*packed.pack_lanes(codes), dev)
        rows = (None if take is None else torch.from_numpy(
            np.sort(rng.choice(n, int(n * take), replace=False))).to(dev))
        note = f"{label}: n={n}, R={n if rows is None else rows.numel()}, N mask {nmask is not None}"
        nbytes, ops = cs.strand_work(lanes, nmask, L, rows)
        bound_ms, by = cs.bound(nbytes, ops)
        fr = torch.cat([lanes, packed.revcomp_lanes(lanes, L, nmask)])
        idx = None if rows is None else torch.cat([rows, rows + n])
        runs = []
        if has_i:
            from pgrc_tpu_torch.kernels import strand_rows as sr

            cs.check_strand((lanes, nmask, L, rows), f"{tree} {note}", 0, timed=False)
            runs.append(("I", lambda: sr.strand_rows(lanes, nmask, L, rows)))
        if rows is None:
            runs.append(("revcomp_lanes + cat", lambda: torch.cat(
                [lanes, packed.revcomp_lanes(lanes, L, nmask)])))
        else:
            runs.append(("index_select", lambda: torch.index_select(fr, 0, idx)))
        for name, fn in runs:
            ms = cs.cuda_ms(fn, REPS)
            print(f"[ab] {tree} strand rows {name} {note}: {ms:.4f} ms, bound {bound_ms:.4f} "
                  f"ms ({by}: {nbytes} B), share {bound_ms / ms:.3f}", flush=True)
        del lanes, nmask, rows, fr, idx, runs
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
    ap.add_argument("--what", choices=("kmer", "sweep", "verify", "strand", "encode"),
                    required=True)
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
        elif args.what == "verify":
            verify_tree(trees[0])
        elif args.what == "strand":
            strand_tree(trees[0])
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
