#!/usr/bin/env python3
"""Kernels B (index_kmer_hash) and C (probe_kmer_hash) of several checkouts,
timed on one CUDA card with chip_smoke.py's timer.

    python3 kmer_hash_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repo. Each runs in a process of
its own, in the order given (`old new new old` interleaves two trees), and
builds its own kernels. That process imports pgrc_tpu_torch from its tree
and chip_smoke.py from beside this script: its `cuda_ms` (the device time of
each call, with the L2 cache evicted before it), `bound` and `hash_ops`. On
random lanes it then times, each against its tree's plain version first
(bit-equal required):
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
kernel moves) and the share. Without a CUDA card it exits 2.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

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


def load_timer():
    """chip_smoke.py from beside this script (not the tree's own copy)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_timer",
                                                  os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rand_lanes(shape, dev):
    return torch.randint(-(1 << 31), (1 << 31) - 1, shape, dtype=torch.int32, device=dev)


def one_tree(tree: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import pgrc_tpu_torch
    from pgrc_tpu_torch import kernels
    from pgrc_tpu_torch.kernels import kmer_hash as kh

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(pgrc_tpu_torch.__file__)))
    if pkg != tree:
        raise SystemExit(f"pgrc_tpu_torch came from {pkg}, not {tree}")
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


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kmer_hash_ab: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:
        one_tree(argv[1])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
