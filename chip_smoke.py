#!/usr/bin/env python3
"""Smoke run of the torch port (pgrc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its times; the first failure exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), torch, CUDA,
     nvcc, and whether the host layer's native library loaded;
  2. build: the CUDA kernels from pgrc_tpu_torch/kernels/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes — outputs must be bit-equal — and both timed;
     kernels E (join_carry) and F (sweep_pair_claim) also on adversarial
     inputs (one run over every entry, runs of one entry, runs that end at
     tile edges, one entry, a length off the tile, partners tiles back);
  4. SE 200k (bench.py's headline input): compress through the port's CLI
     on the card, decode with the port's decoder, require an exact multiset
     round trip, every kernel launched, and bits/base <= 0.1412;
  5. SE 2M (bench.py's scale input): the same, with bits/base <= 0.1384
     and the peak device memory; E and F against their plain versions on
     the inputs of this encode's first join and first sweep round; a
     second encode under torch.profiler: the device busy share, the
     kernels that take the device time, and no cummax kernel;
  6. large pg: the matcher with the encoder's lazy index where the blocked
     index and the wide probe trigger on their own, a 300M-symbol pg (2
     index blocks, int32 positions) and a 2.3G-symbol pg (9 blocks, int64
     positions), 2^20 planted reads each: >= 99% back at their planted
     position and strand, every match re-verified on the host, one kernel B
     launch per block. On the same pgs, kernel B at a block start (int32 and
     int64), kernel A's int64 form and kernel E on the match's first join
     (111M entries) against their plain versions; a second match_reads
     under torch.profiler;
  7. modes at 30k reads (bench.py's generator, with a pair file): SE -l 2,
     PE, MIN_PE, SE_ORD, PE_ORD, and SE with the sweep and index caps
     lowered (a partitioned sweep, a blocked index): the card's archive
     byte-identical to the port's CPU run, an exact decode, kernels launched;
  8. PE 2x200k and SE_ORD 200k (bench.py's inputs): exact round trips,
     bits/base, Mbases/s, peak device memory, E and F launched.
The last lines are the kernels' JSON record (with each kernel's bound: the
bytes it must move over 3.35 TB/s or the 32-bit integer operations of the
function's cheapest exact formulation over 16.7 T/s, whichever is larger),
the card's nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA card it exits 2 and prints no
result. It imports nothing of JAX and nothing of pgrc_tpu.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
L = 100
SE_RUNS = (  # label, reads, genome, seed, bits/base gate, pgrc_tpu's archive
    # bytes with zstd, the port's archive without zstd: bytes and sha256 (the
    # card's archive since the port's first card run; PERF.md section 2)
    ("SE 200k", 200_000, 500_000, 7, 0.1412, 346_639,
     (345_418, "a37e81589535e79995bc5e2cb1d4c69a5fb9d6612c14cb961db654d72644f921")),
    ("SE 2M", 2_000_000, 5_000_000, 9, 0.1384, None,
     (3_445_090, "ad4078497e92d34fe603460f0459d1c6faa3b0449b3f3f9bf3864cc3d2d0efe2")),
)
REPLACES = {
    "verify_best": ("pgrc_tpu_torch/kernels/csrc/verify.cu", "exp_pallas_verify.py:91"),
    "index_kmer_hash": ("pgrc_tpu_torch/kernels/csrc/kmer_hash.cu",
                        "pgrc_tpu/align/matcher.py:469"),
    "probe_kmer_hash": ("pgrc_tpu_torch/kernels/csrc/kmer_hash.cu",
                        "pgrc_tpu/align/matcher.py:213"),
    "sweep_roll_entries": ("pgrc_tpu_torch/kernels/csrc/sweep_round.cu",
                           "pgrc_tpu/overlap/greedy_scs.py:235"),
    "join_carry": ("pgrc_tpu_torch/kernels/csrc/join_carry.cu",
                   "pgrc_tpu/align/matcher.py:239"),
    "sweep_pair_claim": ("pgrc_tpu_torch/kernels/csrc/sweep_pair_claim.cu",
                         "pgrc_tpu/overlap/greedy_scs.py:267"),
}
# variants: JSON name -> (kernel, the launch counter of the path that runs it)
VARIANTS = {
    "verify_best.int64": ("verify_best", "verify_best.int64"),
    "index_kmer_hash.block": ("index_kmer_hash", "index_kmer_hash"),
    "index_kmer_hash.int64": ("index_kmer_hash", "index_kmer_hash.int64"),
    "join_carry.int64": ("join_carry", "join_carry.int64"),
}
# the main path's int32 kernels: SE 200k and every mode launch each of them
MAIN_KERNELS = tuple(REPLACES)
SCAN_KERNELS = ("join_carry", "sweep_pair_claim")
LARGE_PGS = (  # label, pg symbols, seed, lane_off of the kernel B block checked
    ("pg 300M", 300_000_007, 21, 1 << 24),
    ("pg 2.3G", 2_300_000_003, 22, 1 << 27),
)
PLANTED = 1 << 20
WIDE_FROM = 0x7FFF0000   # the matcher's wide probe: pg_len > WIDE_FROM - L
PAST_INT32 = 1 << 31     # kernel A's int64 check verifies starts from here on
MODE_READS, MODE_GENOME = 30_000, 200_000
MODE_CASES = (  # label, argv ({s}: reads, {p}: pair), decode check, caps lowered
    ("SE -l 2", ["-l", "2", "-i", "{s}"], "reads", False),
    ("PE", ["-i", "{s}", "{p}"], "pairs", False),
    ("MIN_PE", ["-s", "-i", "{s}", "{p}"], "unordered pairs", False),
    ("SE_ORD", ["-o", "-i", "{s}"], "order", False),
    ("PE_ORD", ["-o", "-i", "{s}", "{p}"], "order", False),
    ("SE capped", ["-i", "{s}"], "reads", True),
)
BENCH_200K = (  # label, argv, decode check, pgrc_tpu's bits/base (BENCH_r05.json)
    ("PE 2x200k", ["-i", "{s}", "{p}"], "pairs", 0.1728),
    ("SE_ORD 200k", ["-o", "-i", "{s}"], "order", 0.3052),
)
# the card's rates for the bound: HBM3 bytes per second (the published
# 3.35 TB/s), and 32-bit integer operations per second: 132 SMs x 64 INT32
# operations a clock x 1.98 GHz (the SXM part's SM count and boost clock)
HBM_BYTES_S = 3.35e12
INT_OPS_S = 132 * 64 * 1.98e9
# 32-bit integer operations per element of the cheapest exact formulation
# of each function, not of the kernel's own loop: A per verified window
# lane (shift, or, xor, or, and, popc, add, load) and per slot (test and
# select); B and C as prefix hashes, P[j] = P[j-1] * B + v[j] per symbol
# read (shift, and, multiply, add) and H = P[i+k-1] - P[i-1] * B^k per
# k-mer (multiply, subtract) — the same u32 hashes as the kernels' Horner
# chain of k multiply-adds; D per row (four 64-bit multiply-adds and the
# entry build); E and F per entry of a sequential segmented max-scan
# (boundary compare, two selects, two maxima, the epilogue's test and
# select, its index)
OPS_A_LANE, OPS_A_SLOT, OPS_HASH_SYM, OPS_HASH_KMER, OPS_D_ROW, OPS_SCAN = 8, 4, 4, 2, 60, 8
POS_MASK = (1 << 35) - 1
U32_MASK = 0xFFFFFFFF


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the card (CUDA events, after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    """Largest |a - b| over paired outputs, as integers (0 = bit-equal)."""
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in zip(a, b))


def bound(nbytes: int, ops: int) -> tuple:
    """The least time the card could take: (ms, what sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / INT_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> str:
    from pgrc_tpu_torch import native
    from pgrc_tpu_torch.kernels import build
    from pgrc_tpu_torch.streams import codecs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    zstd = codecs._zstd.ZSTD_VERSION if codecs._zstd is not None else None
    say(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvcc: {(nvcc.stdout.strip().splitlines() or ['?'])[-1]} | "
        f"host native library loaded: {native.get_lib() is not None} | "
        f"zstd {zstd} (stream coders are host code: their library versions "
        f"decide archive bytes)")
    return smi


def phase_build() -> None:
    from pgrc_tpu_torch.kernels import build

    b = build.build()
    build.lib()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", b.log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", b.log))
    say(f"[build] {os.path.relpath(b.path, HERE)} in {b.seconds:.1f} s: "
        f"{len(build.sources())} sources, {len(regs)} kernel entries, "
        f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
        f"{spills} bytes of spill stores")


def record(name, run, run_plain, reps, note, nbytes, ops, library=None, err=None):
    """One kernel against its plain version on the same inputs: bit-equal
    outputs required, both timed, and the one-call library yardstick where
    there is one. `err` is the caller's own comparison, for a kernel that
    writes in place and must be compared on separate copies of its outputs.
    -> the kernel's JSON fields (without launches)."""
    if err is None:
        got, want = run(), run_plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        del got, want
    ms, plain_ms = cuda_ms(run, reps), cuda_ms(run_plain, max(1, reps // 10))
    lib_ms = cuda_ms(library, max(1, reps // 10)) if library is not None else None
    bound_ms, bound_by = bound(nbytes, ops)
    say(f"[kernel] {name} {note}: max_abs_err {err}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B, {ops} ops), "
        f"{bound_ms / ms:.3f} of the bound")
    require(err == 0, f"{name} {note}: kernel differs from its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def hash_ops(symbols: int, kmers: int) -> int:
    """Operations of the prefix-hash formulation of kernels B and C: a
    prefix over the symbols read, one difference per k-mer."""
    return symbols * OPS_HASH_SYM + kmers * OPS_HASH_KMER


def verify_work(lanes, start_all, in_range, pg_lanes, n_verify):
    """Bytes and operations of one verify_best call on these inputs: the read
    lanes, starts and masks read once, the pg lanes of every verified window
    (at most the whole pg), (mis, pos) written once."""
    R, S = start_all.shape
    W1 = lanes.shape[1]
    verified = int(in_range.sum(1).clamp(max=n_verify).sum())
    pg_bytes = min(pg_lanes.numel() * 4, verified * (W1 + 1) * 4)
    nbytes = (lanes.numel() * 4 + R * S * (start_all.element_size() + 1) + pg_bytes
              + R * (1 + start_all.element_size()))
    return nbytes, verified * (W1 + 1) * OPS_A_LANE + R * S * OPS_A_SLOT


def join_work(skey, ipos, P):
    """Bytes and operations of kernel E on these inputs: every key read once,
    perm and the gathered position only for index entries, one result per
    probe."""
    n_idx = int(((skey & U32_MASK) == 0).sum())
    return (8 * skey.numel() + n_idx * (8 + ipos.element_size()) + 8 * P,
            OPS_SCAN * skey.numel())


def join_cummaxes(skey, perm, ipos, P):
    """The two torch.cummax calls E replaces (matcher.py's carry), on these
    inputs: a callable that makes both, as the library yardstick."""
    m2 = skey.numel()
    idx = torch.arange(m2, dtype=torch.int64, device=skey.device)
    boundary = torch.ones((m2,), dtype=torch.bool, device=skey.device)
    boundary[1:] = (skey[1:] >> 32) != (skey[:-1] >> 32)
    seg_in = torch.where(boundary, idx, 0)
    seg_start = torch.cummax(seg_in, 0).values
    pos = torch.cat([ipos.clamp(min=0).to(torch.int64),
                     torch.zeros((P,), dtype=torch.int64, device=skey.device)])[perm]
    packv = torch.where((skey & U32_MASK) == 0, (seg_start << 35) | (POS_MASK - pos), 0)
    del idx, boundary, seg_start, pos
    return lambda: (torch.cummax(seg_in, 0), torch.cummax(packv, 0))


def check_join(name, args, note, reps, timed=True):
    """Kernel E against its plain version on (skey, perm, ipos, P)."""
    from pgrc_tpu_torch.kernels import join_carry as kj

    run = lambda: (kj.join_carry(*args),)
    run_plain = lambda: (kj.join_carry_plain(*args),)
    if not timed:
        err = max_abs_err(run(), run_plain())
        require(err == 0, f"{name} {note}: kernel differs from its plain version")
        return err
    return record(name, run, run_plain, reps, note, *join_work(args[0], args[2], args[3]),
                  library=join_cummaxes(*args))


def pair_work(args, a_s_after, a_p_after):
    """Bytes and operations of kernel F on these inputs: keys and entry
    indices read once and each entry's k2 gathered; a paired suffix
    gathers its partner's ent, k2, v2, orig and its own v2, orig and clears
    one a_p; a link writes ids, succ, ovl and a_s."""
    ks, a_s, a_p = args[0], args[8], args[9]
    paired = int((a_p & ~a_p_after).sum())
    links = int((a_s & ~a_s_after).sum())
    m = ks.numel()
    return 24 * m + 41 * paired + 13 * links, OPS_SCAN * m


def pair_cummaxes(args):
    """The two torch.cummax calls F replaces (the round's seg_start and first
    suffix), on these inputs, as the library yardstick."""
    from pgrc_tpu_torch.kernels.sweep import SUFFIX_BIT

    ks, ent, k2 = args[0], args[1], args[2]
    m = ks.numel()
    idx = torch.arange(m, dtype=torch.int64, device=ks.device)
    boundary = torch.ones((m,), dtype=torch.bool, device=ks.device)
    boundary[1:] = ks[1:] != ks[:-1]
    is_suf = k2[ent] >= SUFFIX_BIT
    prev_is_suf = torch.zeros_like(is_suf)
    prev_is_suf[1:] = is_suf[:-1]
    seg_in = torch.where(boundary, idx, 0)
    fs_in = torch.where(is_suf & (~prev_is_suf | boundary), idx, -1)
    return lambda: (torch.cummax(seg_in, 0), torch.cummax(fs_in, 0))


def check_pair(name, args, note, reps, timed=True):
    """Kernel F against its plain version on one round's inputs (ks, ent,
    k2, v2, orig, ids, succ_g, ovl_g, a_s, a_p, i, L); the last four tensors
    are updated in place, so each side runs on its own copies of them."""
    from pgrc_tpu_torch.kernels import sweep_pair_claim as kp

    head, outs, tail = args[:6], args[6:10], args[10:]

    def on_copies(fn):
        def run():
            mine = tuple(t.clone() for t in outs)
            fn(*head, *mine, *tail)
            return mine
        return run

    got = on_copies(kp.sweep_pair_claim)()
    want = on_copies(kp.sweep_pair_claim_plain)()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    require(err == 0, f"{name} {note}: kernel differs from its plain version")
    if not timed:
        return err
    # timing: repeated calls on one set of copies write the same values
    mine = tuple(t.clone() for t in outs)
    return record(name, lambda: kp.sweep_pair_claim(*head, *mine, *tail),
                  lambda: kp.sweep_pair_claim_plain(*head, *mine, *tail), reps,
                  note, *pair_work(args, want[2], want[3]), library=pair_cummaxes(args),
                  err=err)


def pair_entries(ids, a_s, a_p, p, h, p2, h2, i=1, L=L):
    """A round's inputs to kernel F from row state, built as kernel D builds
    its entries, then the round's sort (greedy_scs.round_order)."""
    from pgrc_tpu_torch.kernels.sweep import SUFFIX_BIT
    from pgrc_tpu_torch.overlap import greedy_scs
    from pgrc_tpu_torch.utils.uint import SIGN64

    n = ids.numel()
    g = ids.to(torch.int64)
    k1 = torch.cat([torch.where(a_p, p, -1), torch.where(a_s, h, -1)]) ^ SIGN64
    k2 = torch.cat([torch.where(a_p, g, U32_MASK), torch.where(a_s, g | SUFFIX_BIT, U32_MASK)])
    orig = torch.arange(2 * n, dtype=torch.int32, device=ids.device)
    ks, ent = greedy_scs.round_order(k1, a_p, a_s)
    N = int(ids.max()) + 1
    succ = torch.full((N,), -1, dtype=torch.int32, device=ids.device)
    ovl = torch.zeros((N,), dtype=torch.int32, device=ids.device)
    return (ks, ent, k2, torch.cat([p2, h2]), orig, ids, succ, ovl, a_s, a_p, i, L)


def scan_edge_cases(dev) -> int:
    """Kernels E and F on inputs that break a look-back scan that is wrong at
    its edges; -> the number of cases, all bit-equal to the plain versions."""
    from pgrc_tpu_torch import kernels
    from pgrc_tpu_torch.align import matcher

    T = kernels.scan_tile()
    cases = []
    rng = np.random.default_rng(321)
    on = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(dev)

    def join(label, ihash, ipos, hashes, wide=False):
        ih = on(np.asarray(ihash, np.uint32).view(np.int32), np.int32)
        ip = on(ipos, np.int64 if wide else np.int32)
        hs = on(np.asarray(hashes, np.uint32).view(np.int32), np.int32)
        skey, perm = matcher.join_sort(hs, ih, ip)
        check_join("join_carry", (skey, perm, ip, hs.numel()), label, 0, timed=False)
        say(f"[kernel] join_carry {label}: m2={skey.numel()} bit-equal")
        cases.append(label)

    M, P = 3000, 150 * T
    join("one run over all entries", np.full(M, 77), rng.permutation(10 * M)[:M],
         np.full((P // 10, 10), 77))
    join("runs of one entry", rng.permutation(1 << 24)[:50_000], rng.integers(0, 1 << 30, 50_000),
         rng.permutation(1 << 24)[:60_000].reshape(-1, 12), wide=True)
    join("runs ending at tile edges", np.repeat(np.arange(64) * 7, 512),
         rng.permutation(1 << 20)[:64 * 512], np.repeat(np.arange(64) * 7, 1536).reshape(-1, 16))
    join("m = 1 (one probe, empty index)", np.zeros(0), np.zeros(0), np.full((1, 1), 5))
    join("m = 1 (one index entry, no probe)", np.full(1, 5), np.full(1, 9), np.zeros((0, 4)))
    join("m off the tile", rng.integers(0, 20_000, 50_001), rng.integers(-1, 1 << 28, 50_001),
         rng.integers(0, 20_000, (7_777, 10)))
    join("inert entries and empty runs, int64", rng.integers(0, 500, 40_000),
         np.where(rng.random(40_000) < 0.3, -1, rng.integers(0, 1 << 34, 40_000)),
         rng.integers(0, 700, (9_000, 9)), wide=True)

    def pair(label, n, hp, hs, act=1.0, ids=None, a_s=None, a_p=None):
        ids_t = on(np.arange(n) if ids is None else ids, np.int32)
        a_s = rng.random(n) < act if a_s is None else a_s
        a_p = rng.random(n) < act if a_p is None else a_p
        args = pair_entries(ids_t, on(a_s, bool), on(a_p, bool),
                            on(np.asarray(hp, np.uint64).view(np.int64), np.int64),
                            on(np.asarray(hs, np.uint64).view(np.int64), np.int64),
                            on(rng.integers(0, 2, n), np.int64), on(rng.integers(0, 2, n), np.int64),
                            i=3)
        check_pair("sweep_pair_claim", args, label, 0, timed=False)
        say(f"[kernel] sweep_pair_claim {label}: m={args[0].numel()} bit-equal")
        cases.append(label)

    n = 100_000
    pair("one run over all entries, partners ~49 tiles back", n, np.zeros(n), np.zeros(n))
    pair("runs of one entry", n, 2 * rng.permutation(n), 2 * rng.permutation(n) + 1)
    pair("runs ending at tile edges", 64 * 1024, np.arange(64 * 1024) // 1024,
         np.arange(64 * 1024) // 1024)
    pair("more suffixes than prefixes", n, rng.integers(0, 50, n) * 3, rng.integers(0, 10, n) * 3,
         act=0.8, ids=np.sort(rng.choice(3 * n, n, replace=False)))
    pair("m = 1", 1, np.zeros(1), np.zeros(1), a_s=np.zeros(1, bool), a_p=np.ones(1, bool))
    pair("m off the tile", 77_777, rng.integers(0, 5_000, 77_777), rng.integers(0, 5_000, 77_777),
         act=0.7)
    return len(cases)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card, at the main path's
    shapes (E and F at theirs in phases 5 and 6), and E and F on their edge
    cases; returns {name: JSON fields}."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.align.matcher import probe_offsets
    from pgrc_tpu_torch.core import packed
    from pgrc_tpu_torch.kernels import kmer_hash, sweep, verify

    rng = np.random.default_rng(123)
    out = {}

    # A: verify_best, R = 2^18 rows, S = 23 slots, reads sampled from the pg
    pg_len, R = 5_000_000, 1 << 18
    offs = probe_offsets(L, 32, 3)
    S = len(offs)
    pg = rng.integers(0, 4, size=pg_len, dtype=np.uint8)
    pg_lanes = state.pg_lanes_to_device(pg, dev)
    true_st = rng.integers(0, pg_len - L + 1, size=R)
    reads = pg[true_st[:, None] + np.arange(L)[None, :]]
    err_mask = rng.random(reads.shape) < 0.02
    reads[err_mask] = (reads[err_mask] + 1) % 4
    lanes, _ = state.lanes_to_device(*packed.pack_lanes(reads), dev)
    jitter = rng.integers(-2, 3, size=(R, S))
    cand = np.where(rng.random((R, S)) < 0.5, true_st[:, None] + jitter,
                    rng.integers(-L, pg_len, size=(R, S)))
    start_all = torch.from_numpy(cand.astype(np.int32)).to(dev)
    in_range = torch.from_numpy(rng.random((R, S)) < 0.7).to(dev)
    rows = {}
    for nv in (6, 1):
        args = (lanes, start_all, in_range, pg_lanes, pg_len - L, L, 33, nv)
        rows[nv] = record("verify_best", lambda: verify.verify_best(*args),
                          lambda: verify.verify_best_plain(*args), 20,
                          f"R={R} S={S} n_verify={nv}",
                          *verify_work(lanes, start_all, in_range, pg_lanes, nv))
    out["verify_best"] = rows[6]

    # B: index_kmer_hash over the 5M-symbol pg, k = 32, k1 = 4
    m = (pg_lanes.numel() - 1) * 16 // 4
    args = (pg_lanes, 32, 4, pg_len, m)
    out["index_kmer_hash"] = record(
        "index_kmer_hash", lambda: kmer_hash.index_kmer_hash(*args),
        lambda: kmer_hash.index_kmer_hash_plain(*args), 20, f"m={m} k=32 k1=4",
        pg_lanes.numel() * 4 + m * 8, hash_ops(m * 4 + 32, m))

    # C: probe_kmer_hash, R = 2^18 rows, S = 23 offsets
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    out["probe_kmer_hash"] = record(
        "probe_kmer_hash", lambda: (kmer_hash.probe_kmer_hash(lanes, offs_t, 32),),
        lambda: (kmer_hash.probe_kmer_hash_plain(lanes, offs_t, 32),), 20,
        f"R={R} S={S} k=32", lanes.numel() * 4 + S * 4 + R * S * 4,
        hash_ops(R * (max(offs) + 32), R * S))

    # D: sweep_roll_entries, n = 2^18 rows, rounds 1..4, without and with N
    n = 1 << 18
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    rows = {}
    for with_n in (False, True):
        if with_n:
            codes[rng.random(n) < 0.05, 7] = 4
        lanes_d, nmask_d = state.lanes_to_device(*packed.pack_lanes(codes), dev)
        gid = torch.arange(n, dtype=torch.int32, device=dev)
        a_s = torch.from_numpy(rng.random(n) < 0.8).to(dev)
        a_p = torch.from_numpy(rng.random(n) < 0.8).to(dev)
        hs0 = [state.hashes_to_device(
            rng.integers(0, 2**63, size=n, dtype=np.uint64) * np.uint64(2) + np.uint64(1),
            dev) for _ in range(4)]
        hk, hp = [h.clone() for h in hs0], [h.clone() for h in hs0]

        def rounds(fn, hs):
            res = []
            for i in range(1, 5):
                res += list(fn(lanes_d, nmask_d, gid, a_s, a_p, i, L, *hs))
            return tuple(res) + tuple(hs)

        got = rounds(sweep.sweep_roll_entries, hk)
        want = rounds(sweep.sweep_roll_entries_plain, hp)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"sweep_roll_entries N={with_n}: kernel differs from plain")
        args = (lanes_d, nmask_d, gid, a_s, a_p, 1, L, *hk)
        ms = cuda_ms(lambda: sweep.sweep_roll_entries(*args), 20)
        plain_ms = cuda_ms(lambda: sweep.sweep_roll_entries_plain(*args), 5)
        row_bytes = 8 + (4 if with_n else 0) + 4 + 2 + 64 + 56
        bound_ms, bound_by = bound(n * row_bytes, n * OPS_D_ROW)
        say(f"[kernel] sweep_roll_entries n={n} rounds 1-4 N={with_n}: max_abs_err "
            f"{err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {n * row_bytes} B), {bound_ms / ms:.3f} of the bound")
        rows[with_n] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    out["sweep_roll_entries"] = rows[True]

    # E and F on their edge cases (their main-path shapes come in phases 5, 6)
    t0 = time.time()
    cases = scan_edge_cases(dev)
    say(f"[kernel] join_carry, sweep_pair_claim: {cases} edge cases bit-equal in "
        f"{time.time() - t0:.1f} s")
    return out


class FirstCall:
    """Spy on a kernel wrapper of the main path: calls through, and keeps
    copies of the inputs of its first call (before a call that writes in
    place). The wrapper counts its own launches, so the spy changes none."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.real, self.args = getattr(module, name), None

    def __enter__(self):
        def spy(*args):
            if self.args is None:
                self.args = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                  for a in args)
            return self.real(*args)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


def cummax_kernel_names(dev) -> set:
    """Names of the scan kernels one torch.cummax launches on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.arange(1 << 16, device=dev, dtype=torch.int64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cummax(x, 0)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    say(f"[kernel] torch.cummax launches {sorted(names)}; the main path must not "
        f"launch its scan kernels")
    return {k for k in names if "scan" in k.lower() or "cum" in k.lower()}


def profiled(fn, label, banned=()):
    """Run fn() under torch.profiler, with the port's trace spans on (their
    `[trace]` lines give the host wall of each span): print the wall, the
    device time (sum of the kernels' and copies' self time), the busy share
    and the eight largest device items; fail if a kernel named in `banned`
    or an aten::cummax op ran. -> fn's result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pgrc_tpu_torch.utils import trace

    torch.cuda.synchronize()
    t0 = time.time()
    was, trace._ON = trace._ON, True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = fn()
            torch.cuda.synchronize()
    finally:
        trace._ON = was
    wall = time.time() - t0
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    self_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    busy = sum(self_us(e) for e in dev) / 1e6
    top = sorted(dev, key=self_us, reverse=True)[:8]
    say(f"[{label}] traced: wall {wall:.3f} s, device time {busy:.3f} s, busy share "
        f"{busy / wall:.3f}; largest: " + "; ".join(
            f"{e.key[:60]} {self_us(e) / 1e3:.1f} ms x{e.count}" for e in top))
    ran = sorted({e.key for e in events if e.key in banned or "cummax" in e.key})
    require(not ran, f"{label}: the traced run launched cummax: {ran}")
    require(busy > 0, f"{label}: the profiler saw no device time")
    return res


def read_decoded(path: str, read_len: int):
    from pgrc_tpu_torch.utils import dna

    raw = np.fromfile(path, dtype=np.uint8)
    return dna.SYM2VAL[raw.reshape(-1, read_len + 1)[:, :read_len]]


def phase_se(label, n_reads, genome, seed, gate, ref_bytes, card_archive, work,
             first, timings, banned):
    """Compress through the port's CLI on the card, decode, check. The launch
    counts are reset before and read after the encode. On the first run the
    same input is also compressed with the plain versions on the CPU (the two
    archives must be byte-identical) and bench.py's pair file is written
    beside the input for phase 8; on the others, E and F are held against
    their plain versions on the encode's first join and first sweep round,
    and a second encode runs under torch.profiler. -> (launches, src, pair,
    codes)."""
    from pgrc_tpu_torch import cli, kernels, synth
    from pgrc_tpu_torch.align import matcher
    from pgrc_tpu_torch.archive import decoder
    from pgrc_tpu_torch.overlap import greedy_scs
    from pgrc_tpu_torch.streams import codecs

    src = os.path.join(work, f"se_{n_reads}.fastq")
    pair = os.path.join(work, f"se_{n_reads}_2.fastq") if first else None
    t0 = time.time()
    codes = synth.synth_fastq(src, n_reads, L, genome, seed=seed, pair=pair)
    gen_s = time.time() - t0
    archive = os.path.join(work, f"se_{n_reads}.pgtc")
    report = os.path.join(work, f"se_{n_reads}.tsv")
    argv = ["--device", "cuda", "-R", report, "-i", src, archive]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with FirstCall(matcher, "join_carry") as join, \
            FirstCall(greedy_scs, "sweep_pair_claim") as pair_round:
        t0 = time.time()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        enc_s = time.time() - t0
    launches = dict(kernels.launches)
    require(rc == 0, f"{label}: compress exited {rc}")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    size = os.path.getsize(archive)
    cpu_same = None
    if first:
        cpu_archive = os.path.join(work, f"se_{n_reads}_cpu.pgtc")
        t0 = time.time()
        require(cli.main(["--device", "cpu", "-i", src, cpu_archive]) == 0,
                f"{label}: CPU compress failed")
        with open(archive, "rb") as a, open(cpu_archive, "rb") as b:
            cpu_same = a.read() == b.read()
        say(f"[{label}] plain versions on the CPU: {time.time() - t0:.2f} s, "
            f"archive byte-identical to the card's: {cpu_same}")
    bases = n_reads * L
    bits = size * 8 / bases
    t0 = time.time()
    n_out = decoder.decode_to_files(archive, os.path.join(work, f"dec_{n_reads}"))
    dec_s = time.time() - t0
    same = n_out == n_reads and decoder._multiset_equal(
        read_decoded(os.path.join(work, f"dec_{n_reads}_out"), L), codes)
    with open(report) as f:
        head, row = f.read().splitlines()[:2]
    stages = dict(zip(head.split("\t")[6:], row.split("\t")[6:]))
    with open(archive, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    say(f"[{label}] archive {size} B sha256 {digest} (pgrc_tpu with zstd: "
        f"{ref_bytes or 'not recorded'}; the port's recorded card archive without zstd: "
        f"{card_archive[0]}), {bits:.6f} bits/base (gate {gate}), encode {enc_s:.2f} s = "
        f"{bases / 1e6 / enc_s:.2f} Mbases/s, decode {dec_s:.2f} s = "
        f"{bases / 1e6 / dec_s:.2f} Mbases/s, input synth {gen_s:.1f} s, "
        f"peak device memory {peak_mb:.0f} MiB, stage s {stages}, "
        f"exact multiset round trip {same}, launches {launches}")
    require(same, f"{label}: decoded reads differ from the input")
    require(cpu_same is not False, f"{label}: the card's archive differs from the CPU's")
    require(bits <= gate, f"{label}: {bits:.6f} bits/base exceeds {gate}")
    if codecs._zstd is None:
        require((size, digest) == card_archive, f"{label}: {size} B sha256 {digest}, not "
                f"the port's recorded card archive without zstd ({card_archive})")
    idle = [k for k in MAIN_KERNELS if launches[k] == 0]
    require(not idle, f"{label}: kernels never launched on the main path: {idle}")
    if not first:
        skey, perm, ipos, P = join.args
        timings["join_carry"] = check_join(
            "join_carry", join.args, f"{label}'s first join: m2={skey.numel()} "
            f"({ipos.numel()} index entries, {P} probes)", 20)
        ks = pair_round.args[0]
        timings["sweep_pair_claim"] = check_pair(
            "sweep_pair_claim", pair_round.args, f"{label}'s first sweep round: "
            f"m={ks.numel()} entries of {pair_round.args[5].numel()} rows", 20)
        del join.args, pair_round.args
        free_card()
        profiled(lambda: cli.main(argv), f"{label} second encode", banned)
    return launches, src, pair, codes


def fastq_codes(path: str):
    """The read lines of a FASTQ file (4 lines a record) as codes [n, L]."""
    from pgrc_tpu_torch.utils import dna

    with open(path, "rb") as f:
        seqs = f.read().split(b"\n")[1::4]
    return dna.SYM2VAL[np.frombuffer(b"".join(seqs), dtype=np.uint8).reshape(len(seqs), -1)]


def unordered(a, b):
    """Each pair (a[i], b[i]) as one row, lexicographically lower read first
    (MIN_PE keeps the pairs but not the order within one)."""
    diff = a != b
    first = diff.argmax(axis=1)
    rows = np.arange(a.shape[0])
    swap = diff.any(axis=1) & (a[rows, first] > b[rows, first])
    return np.where(swap[:, None], np.concatenate([b, a], axis=1),
                    np.concatenate([a, b], axis=1))


def decodes_exactly(archive: str, prefix: str, kind: str, inputs: list):
    """Decode with the port's decoder and compare with the input reads:
    in order ("order"), as a multiset of pairs ("pairs"), of unordered pairs
    ("unordered pairs") or of reads ("reads"). Never decoder.validate, which
    accepts swapped bytes and swapped pairs. -> (exact, decode seconds)."""
    from pgrc_tpu_torch.archive import decoder

    t0 = time.time()
    n = decoder.decode_to_files(archive, prefix)
    dec_s = time.time() - t0
    return _same_reads(prefix, n, kind, inputs), dec_s


def _same_reads(prefix: str, n: int, kind: str, inputs: list) -> bool:
    from pgrc_tpu_torch.archive import decoder

    outs = ([prefix + "_out"] if len(inputs) == 1
            else [prefix + "_out_1", prefix + "_out_2"])
    got = [read_decoded(o, L) for o in outs]
    if n != sum(c.shape[0] for c in inputs) or len(got) != len(inputs):
        return False
    if kind == "order":
        return all(np.array_equal(g, w) for g, w in zip(got, inputs))
    if kind == "pairs":
        return decoder._multiset_equal(np.concatenate(got, axis=1),
                                       np.concatenate(inputs, axis=1))
    if kind == "unordered pairs":
        return decoder._multiset_equal(unordered(*got), unordered(*inputs))
    return decoder._multiset_equal(np.concatenate(got), np.concatenate(inputs))


def free_card() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_large_pg(dev, label, pg_len, seed, lane_off, banned):
    """The blocked index (and, past 2^31 symbols, the wide probe) where they
    trigger on their own. One pg serves the kernel checks and the match run.
    -> ({variant: JSON fields}, launches of the match run)."""
    from pgrc_tpu_torch import kernels, state
    from pgrc_tpu_torch.align import matcher
    from pgrc_tpu_torch.align.matcher import probe_offsets
    from pgrc_tpu_torch.config import PgRCParams, matching_chars_correction
    from pgrc_tpu_torch.core import packed
    from pgrc_tpu_torch.kernels import kmer_hash, verify

    t0 = time.time()
    rng = np.random.default_rng(seed)
    pg = rng.integers(0, 4, size=pg_len, dtype=np.uint8)
    st = rng.integers(0, pg_len - L + 1, size=PLANTED)
    reads = pg[st[:, None] + np.arange(L)[None, :]]
    # one substitution in half the reads (0.5% of the bases), in the last 4
    # symbols of the planted window: every read keeps >= 5 exact anchors at
    # indexed positions. With one uniform substitution some reads kept one,
    # and a hash collision with a lower entry of a 2^26-entry block lost it
    # (46 of 2^20 reads at the 300M pg); 16 or more unmatched reads send the
    # host rescue to build its index over the whole pg, minutes at 2G symbols
    sub = np.nonzero(rng.random(PLANTED) < 0.5)[0]
    col = rng.integers(L - 4, L, size=sub.size)
    reads[sub, col] = (reads[sub, col] + rng.integers(1, 4, size=sub.size, dtype=np.uint8)) % 4
    rc = rng.random(PLANTED) < 0.5
    reads[rc] = packed.revcomp_codes_matrix(reads[rc])
    prm = PgRCParams()
    prm.resolve()
    k = prm.seed_k + matching_chars_correction(pg_len)   # as the encoder
    max_mis = L // prm.min_chars_per_mismatch
    wide = pg_len > WIDE_FROM - L
    say(f"[{label}] pg {pg_len} symbols, {PLANTED} planted reads (half reverse "
        f"complemented, one substitution in half of them), k {k}, max_mis {max_mis}, wide {wide}; "
        f"input {time.time() - t0:.1f} s")

    # kernel B at a block start and (wide) kernel A's int64 form, on this pg
    t0 = time.time()
    out = {}
    pg_lanes = state.pg_lanes_to_device(pg, dev)
    n_lanes = pg_lanes.numel() - 1
    wp = matcher._MAX_INDEX_BLOCK * 4 // 16          # lanes of one block at k1 = 4
    m = (min(lane_off + wp, n_lanes) - lane_off) * 16 // 4
    args = (pg_lanes, k, 4, pg_len, m, lane_off, wide)
    pos_bytes = 8 if wide else 4
    out["index_kmer_hash.int64" if wide else "index_kmer_hash.block"] = record(
        "index_kmer_hash", lambda: kmer_hash.index_kmer_hash(*args),
        lambda: kmer_hash.index_kmer_hash_plain(*args), 10,
        f"{'int64' if wide else 'int32'} block at lane_off {lane_off} (positions "
        f"{lane_off * 16}..{lane_off * 16 + m * 4 - 4}), m={m} k={k} k1=4",
        (m // 4 + k // 16 + 2) * 4 + m * (4 + pos_bytes), hash_ops(m * 4 + k, m))
    if wide:
        R, offs = 1 << 18, probe_offsets(L, k, 3)
        S = len(offs)
        true_st = rng.integers(PAST_INT32, pg_len - L + 1, size=R)
        vr = pg[true_st[:, None] + np.arange(L)[None, :]]
        vmask = rng.random(vr.shape) < 0.02
        vr[vmask] = (vr[vmask] + 1) % 4
        lanes, _ = state.lanes_to_device(*packed.pack_lanes(vr), dev)
        cand = np.where(rng.random((R, S)) < 0.5,
                        true_st[:, None] + rng.integers(-2, 3, size=(R, S)),
                        rng.integers(PAST_INT32 - L, pg_len, size=(R, S)))
        start_all = torch.from_numpy(cand.astype(np.int64)).to(dev)
        in_range = torch.from_numpy(rng.random((R, S)) < 0.7).to(dev)
        vargs = (lanes, start_all, in_range, pg_lanes, pg_len - L, L, max_mis, 6)
        out["verify_best.int64"] = record(
            "verify_best", lambda: verify.verify_best(*vargs),
            lambda: verify.verify_best_plain(*vargs), 20,
            f"int64 R={R} S={S} n_verify=6, starts {int(cand.min())}..{int(cand.max())}",
            *verify_work(lanes, start_all, in_range, pg_lanes, 6))
        del lanes, start_all, in_range
    del pg_lanes
    free_card()
    say(f"[{label}] kernel checks {time.time() - t0:.1f} s")

    index = matcher.build_index(pg, k=k, device_sort=True)
    blocks = -(-(pg_len - k + 1) // (matcher._MAX_INDEX_BLOCK * index.k1))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    run = lambda: matcher.match_reads(reads, index, pg, max_mis, cap=prm.match_cap,
                                      accept_mis=0, device=dev)
    with FirstCall(matcher, "join_carry") as join:
        t0 = time.time()
        res = run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches = dict(kernels.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    free_card()
    hit = (res.pos == st) & (res.rc == rc)
    got = np.nonzero(res.pos >= 0)[0]
    win = pg[res.pos[got, None] + np.arange(L)[None, :]]
    ori = reads[got]
    ori = np.where(res.rc[got, None], packed.revcomp_codes_matrix(ori), ori)
    exact = (win != ori).sum(axis=1) == res.mis[got]
    b_key, a_key, e_key = (("index_kmer_hash.int64", "verify_best.int64", "join_carry.int64")
                           if wide else ("index_kmer_hash", "verify_best", "join_carry"))
    say(f"[{label}] match_reads {wall:.2f} s, peak device memory {peak_mb:.0f} MiB, "
        f"{hit.mean():.6f} at the planted position and strand, {got.size} matched, "
        f"{int(exact.sum())} re-verified exactly, index blocks {blocks}, "
        f"launches {launches}")
    require(hit.mean() >= 0.99, f"{label}: {hit.mean():.4f} of the reads at their plant")
    miss = np.nonzero(res.pos < 0)[0][:8]
    require(PLANTED - got.size <= 15, f"{label}: {PLANTED - got.size} reads unmatched "
            f"(planted at {st[miss].tolist()}, rc {rc[miss].tolist()})")
    require(exact.all() and (res.mis[got] <= max_mis).all(),
            f"{label}: {int((~exact).sum())} matches fail the host re-verify")
    require(blocks >= (8 if wide else 2) and launches[b_key] == blocks,
            f"{label}: {launches[b_key]} kernel B launches for {blocks} index blocks")
    other = ("index_kmer_hash", "verify_best", "join_carry") if wide else (
        "index_kmer_hash.int64", "verify_best.int64", "join_carry.int64")
    require(launches[a_key] > 0 and launches["probe_kmer_hash"] > 0
            and launches[e_key] >= blocks and not any(launches[o] for o in other),
            f"{label}: the probe did not run on its {'int64' if wide else 'int32'} kernels")
    del res
    t0 = time.time()
    skey, perm, ipos, P = join.args
    fields = check_join("join_carry", join.args, f"{'int64' if wide else 'int32'}, "
                        f"{label}'s first join: m2={skey.numel()} ({ipos.numel()} index "
                        f"entries, {P} probes)", 5)
    if wide:
        out["join_carry.int64"] = fields
    del join.args, skey, perm, ipos
    free_card()
    say(f"[{label}] kernel E check {time.time() - t0:.1f} s")
    profiled(run, f"{label} second match_reads", banned)
    free_card()
    return out, launches


def phase_modes(work: str) -> None:
    """Every archive mode on the card against the port's own CPU run."""
    from pgrc_tpu_torch import cli, kernels, synth
    from pgrc_tpu_torch.align import matcher
    from pgrc_tpu_torch.overlap import greedy_scs

    src, pair = (os.path.join(work, f"modes{i}.fastq") for i in (1, 2))
    codes = {"{s}": synth.synth_fastq(src, MODE_READS, L, MODE_GENOME, seed=5, pair=pair),
             "{p}": fastq_codes(pair)}
    parts = []
    real_partitioned = greedy_scs._find_overlaps_partitioned

    def partitioned(codes_, coef, *, device):
        parts.append(codes_.shape[0])
        return real_partitioned(codes_, coef, device=device)

    for label, argv_t, kind, capped in MODE_CASES:
        argv = [{"{s}": src, "{p}": pair}.get(a, a) for a in argv_t]
        inputs = [codes[a] for a in argv_t if a in codes]
        caps = (greedy_scs._SWEEP_MAX_ROWS, matcher._MAX_INDEX_BLOCK)
        if capped:
            greedy_scs._SWEEP_MAX_ROWS, matcher._MAX_INDEX_BLOCK = 8192, 1 << 14
            greedy_scs._find_overlaps_partitioned = partitioned
        try:
            name = label.replace(" ", "_")
            card, cpu = (os.path.join(work, f"{name}.{d}.pgtc") for d in ("card", "cpu"))
            kernels.reset_launches()
            t0 = time.time()
            require(cli.main(["--device", "cuda", *argv, card]) == 0,
                    f"{label}: compress on the card failed")
            torch.cuda.synchronize()
            card_s = time.time() - t0
            launches = dict(kernels.launches)
            t0 = time.time()
            require(cli.main(["--device", "cpu", *argv, cpu]) == 0,
                    f"{label}: compress on the CPU failed")
            cpu_s = time.time() - t0
        finally:
            greedy_scs._SWEEP_MAX_ROWS, matcher._MAX_INDEX_BLOCK = caps
            greedy_scs._find_overlaps_partitioned = real_partitioned
        with open(card, "rb") as a, open(cpu, "rb") as b:
            same = a.read() == b.read()
        exact, _ = decodes_exactly(card, os.path.join(work, f"{name}.dec"), kind, inputs)
        say(f"[modes] {label}: card {card_s:.2f} s, CPU {cpu_s:.2f} s, "
            f"{os.path.getsize(card)} B, byte-identical {same}, exact decode ({kind}) "
            f"{exact}, launches {launches}" + (f", partitioned sweeps of {parts} rows"
                                               if capped else ""))
        require(same, f"{label}: the card's archive differs from the CPU's")
        require(exact, f"{label}: the decoded reads differ from the input")
        idle = [k for k in MAIN_KERNELS if launches[k] == 0]
        require(not idle, f"{label}: kernels never launched: {idle}")
        if capped:
            require(parts and launches["index_kmer_hash"] >= 2,
                    f"{label}: no partitioned sweep or no blocked index")


def phase_bench_200k(src: str, pair: str, codes) -> None:
    """bench.py's PE and SE_ORD rows on the card: exact round trips."""
    from pgrc_tpu_torch import cli, kernels

    inputs = {"{s}": codes, "{p}": fastq_codes(pair)}
    for label, argv_t, kind, ref_bpb in BENCH_200K:
        argv = [{"{s}": src, "{p}": pair}.get(a, a) for a in argv_t]
        ins = [inputs[a] for a in argv_t if a in inputs]
        archive = os.path.join(os.path.dirname(src), label.replace(" ", "_") + ".pgtc")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.time()
        require(cli.main(["--device", "cuda", *argv, archive]) == 0,
                f"{label}: compress failed")
        torch.cuda.synchronize()
        enc_s = time.time() - t0
        launches = dict(kernels.launches)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        exact, dec_s = decodes_exactly(archive, archive + ".dec", kind, ins)
        bases = sum(c.size for c in ins)
        size = os.path.getsize(archive)
        say(f"[{label}] archive {size} B, {size * 8 / bases:.6f} bits/base (pgrc_tpu "
            f"with zstd: {ref_bpb}), encode {enc_s:.2f} s = {bases / 1e6 / enc_s:.2f} "
            f"Mbases/s, decode {dec_s:.2f} s = {bases / 1e6 / dec_s:.2f} "
            f"Mbases/s, peak device memory {peak_mb:.0f} MiB, exact round trip "
            f"({kind}) {exact}, launches {launches}")
        require(exact, f"{label}: the decoded reads differ from the input")
        idle = [k for k in SCAN_KERNELS if launches[k] == 0]
        require(not idle, f"{label}: kernels never launched: {idle}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import pgrc_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    t_all = time.time()
    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    timings = phase_kernels(dev)
    banned = cummax_kernel_names(dev)
    say(f"[time] phases 1-3 {time.time() - t_all:.1f} s")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=HERE)
    try:
        t0 = time.time()
        launches, src, pair, codes = phase_se(*SE_RUNS[0], work=work, first=True,
                                              timings=timings, banned=banned)
        for run in SE_RUNS[1:]:
            phase_se(*run, work=work, first=False, timings=timings, banned=banned)
        say(f"[time] phases 4-5 {time.time() - t0:.1f} s")
        variant_launches = {}
        for label, pg_len, seed, lane_off in LARGE_PGS:
            t0 = time.time()
            got, path_launches = phase_large_pg(dev, label, pg_len, seed, lane_off, banned)
            timings.update(got)
            for name in got:
                variant_launches[name] = path_launches[VARIANTS[name][1]]
            say(f"[time] phase 6 {label} {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_modes(work)
        say(f"[time] phase 7 {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_bench_200k(src, pair, codes)
        say(f"[time] phase 8 {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"[total] {time.time() - t_all:.1f} s")
    rows = [(name, name, launches[name]) for name in REPLACES]
    rows += [(name, VARIANTS[name][0], variant_launches[name]) for name in VARIANTS]
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[kernel][0],
         "replaces": REPLACES[kernel][1], "launches": n, **timings[name]}
        for name, kernel, n in rows]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
