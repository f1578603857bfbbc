#!/usr/bin/env python3
"""Smoke run of the torch port (pgrc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its times; the first failure exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), torch, CUDA,
     nvcc, and the host layer's native library, built and loaded;
  2. build: the CUDA kernels from pgrc_tpu_torch/kernels/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes — outputs must be bit-equal — and both timed
     (device time of each call, with the L2 cache evicted before it; the
     card is kept busy while the host queues the timed calls); kernel A
     (verify_best) on 21 edge cases (every window width, its batch of 6
     and of 4 windows, more slots than a 64-bit mask, n_verify 1, 6 and
     12, rows with few or no in-range slots, a pg shorter than the read,
     start residues 0 and 15, the pg's first and last lane, equal
     mismatches at two starts, int64 starts past 2^31, R off the block
     and a warp); kernels B
     (index_kmer_hash) and C (probe_kmer_hash) also on 20 edge cases (a
     ragged tile, one entry, the pg's last lane, block starts, int64
     positions past 2^31, k 24-40 with k1 2-8, offsets at both ends of the
     lanes, one row, more offsets than threads); kernels E
     (join_carry) and F (sweep_pair_claim) on adversarial inputs sized from
     the scan's tile (one run over every entry, past one 32-tile look-back
     window; runs of one entry; runs that end at tile edges; one entry; a
     length off the tile; partners 40 tiles back); every edge case over 10
     launches, each bit-equal; kernels G (sweep_full_hashes), G2
     (sweep_init_links, with its fill sweep_link_defaults), D
     (sweep_roll_entries) and H (sweep_compact) at n
     2^18 rows, and D and H on their scan edge cases
     (m = 0, all active, one active entry at the last position, n off the
     tile, a count scan past one 32-tile look-back window, a compacted
     view whose lanes' column stride is past its rows, there D's sharded
     form too, and columns off 16-byte alignment, there G too), H also at its
     own tile (n on it and one off, a ragged last tile, each output base
     residue mod 4, rows too wide for its tile), G and G2 on theirs
     (one row, rows off the block, more tiles than resident blocks, L 37,
     99, 150 and 255, rows all N, one long run of equal keys; G2 also with no
     tie, every position tied, h0b changing inside runs of equal keys,
     tied pairs across a warp's and a block's edge, ties at the first and
     last positions), and the init (`_init_links`: G, the sort, G2) on the
     card against its CPU run, each over 10 launches; kernel I
     (strand_rows) in its prep and take forms on 36 edge cases (every lane
     count's ends from L 16 to 255, rows off the block, no N, N in 3%, rows
     all N, N at a read's first and last position, a take that repeats
     rows, one row, one row taken 3000 times, random lanes and masks), each
     over 10 launches; kernel J (sweep_verify_links) at SE 2M's full
     sweep (1.76M reads of L 100 at 40x, N in 5% of the rows, 4% of the
     links bad) and on 9 edge cases (L 37, 64, 150 and 255, rows off the
     block, one row, N against A inside overlaps, a third of the links bad,
     a table at the head of wider storage), each over 10 launches; kernels
     A, G, G2, D, H, I and J at L 150 (W 10 lanes a
     row) at an SE 2M encode's sizes (the 2x150 bp cell's 2M reads), each
     bit-equal and timed beside its bound; then the port's graft entry
     (__graft_entry_torch__.entry) on the card against its CPU run;
  4. SE 200k (bench.py's headline input): compress through the port's CLI
     on the card, decode with the port's decoder, require an exact multiset
     round trip, the port's validator (`-d -i`) to pass, every kernel
     launched, and bits/base <= 0.1412;
  5. SE 2M (bench.py's scale input): the same, with bits/base <= 0.1384;
     A, E, F, G, G2 (and its fill), D, H, I and J against their plain
     versions on the inputs of
     this encode's first probe, first join, first init, first sweep round,
     first compaction and first link check (and its share of tied init
     positions) and its
     strand prep (I's take form also on a seeded half of those reads), the
     init on the card against its CPU run there; the same first sweep round
     cut into MESH_RANKS simulated shards (SimRound: the port's own
     greedy_scs._round_sharded on every shard, its collectives answered
     from what every shard sent): every shard's round equal to the
     one-device round, D's and F's sharded forms and the key layout held to
     their plain versions on every shard, rank 0's timed, and rank 0's
     round from D's launch to F's end timed; a second encode under
     torch.profiler, without the spies
     that copy those inputs: the peak device memory, the device busy share, the kernels that take the
     device time (B, C, the sweep's kernels, the sorts, any cat or
     elementwise kernel by name), no cummax kernel, the join's sort
     dispatching torch.sort alone (its keys are B's and C's outputs), no
     op but a view between the join's anchors and kernel A, match_reads
     building its strand rows with kernel I alone (beside the reads' upload)
     and running no index_select (StrandOps), and
     the sweep (every find_overlaps call) dispatching no nonzero, cat, any
     or boolean-mask indexing, with its host syncs counted;
  6. large pg: the matcher with the encoder's lazy index where the blocked
     index and the wide probe trigger on their own, a 300M-symbol pg (2
     index blocks, int32 positions) and a 2.3G-symbol pg (9 blocks, int64
     positions), 2^20 planted reads each: >= 99% back at their planted
     position and strand, every match re-verified on the host, one kernel B
     launch per index block and row batch (the blocks are built per join,
     not held), the peak device memory. On the same pgs, kernel B at a
     block start (int32 and int64), kernel A's int64 form (on synthetic
     rows and on the match's first probe) and kernel E on the match's
     first join (111M entries) against their plain versions; a
     second match_reads under torch.profiler, as in phase 5;
  7. modes at 30k reads (bench.py's generator, with a pair file): SE -l 2,
     PE, MIN_PE, SE_ORD, PE_ORD, and SE with the sweep and index caps
     lowered (a partitioned sweep, a blocked index): the card's archive
     byte-identical to the port's CPU run, an exact decode, kernels launched,
     StrandOps as in phase 5, kernel I's take form launched in SE -l 2 (and
     in no other mode) and held against its plain version on its pass-2
     take, timed beside one torch.index_select of the same rows;
  8. PE 2x200k and SE_ORD 200k (bench.py's inputs): exact round trips,
     the validator passing (PE against both files), bits/base, Mbases/s,
     peak device memory, kernels launched;
  8b. the repeat genome at 200k reads (bench.py's seed 11 and genome
     length, made by `pgrc_tpu_torch.synth`) through the port's CLI on the
     card and on the CPU: byte-identical archives, an exact decode, the
     validator passing, kernels launched;
  9. mesh: MESH_RANKS ranks sharing the card (gloo, which takes the
     ranks' CUDA tensors; parallel.mesh.launch, after the kernels were
     built in phase 2): a rank that raises must fail the launch; gloo's
     all_gather and all_reduce on CUDA tensors, values checked; SE 200k's HQ reads
     swept on one device and over the ranks (each rank's links equal to
     one device's, its host syncs counted, no banned op), the SE 200k
     encode over the ranks (each rank's archive equal to phase 4's, its
     launches, wall, time in collectives, and a second encode's device
     time under torch.profiler), D's and F's sharded forms and the key
     layout held to their plain versions and timed on rank 0's first
     sharded round, and the sweep's rounds under a dispatch spy
     (RoundGap): between the records gather and F's sharded form only
     views, allocations and the sort may run; then the same round over
     simulated shards on this process's card, as SE 2M's in phase 5.
     Phase 3 holds the sharded forms and the key layout on 8 edge cases
     (simulated shards: a rank with no rows, n not divisible by the ranks,
     a rank with no active prefix, one with no active suffix, an equal-hash
     run across ranks, every entry on one rank, send buffers filled to
     their last word, one run over 80 tiles), each over 10 launches.
"Kernels launched" is each run's expected set, no more and no fewer among
the sweep's: the matcher's A, B, C, E and I; G, D, F and J wherever a device
sweep ran (inputs past 3072 reads; any input under a mesh, where D and F
run their sharded forms, and the key layout), G2 and its fill (sweep_link_defaults)
where one ran its init (not a repair), and H where a device sweep table
had more than 32,768 rows (the one table size that compacts; a rank's
rows under a mesh).
    python3 chip_smoke.py --kernels-only
runs phases 1-3 and the entry alone (a kernel's first build and check)
and prints no result.
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
# the 2x150 bp cell's read length: W 10 lanes a row, 149 sweep rounds a table
L150 = 150
# ranks of phase 9, all on the one card
MESH_RANKS = 4
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
    "sweep_full_hashes": ("pgrc_tpu_torch/kernels/csrc/sweep_init.cu",
                          "pgrc_tpu/overlap/greedy_scs.py:417, :471"),
    "sweep_link_defaults": ("pgrc_tpu_torch/kernels/csrc/sweep_init.cu",
                            "pgrc_tpu/overlap/greedy_scs.py:457"),
    "sweep_init_links": ("pgrc_tpu_torch/kernels/csrc/sweep_init.cu",
                         "pgrc_tpu/overlap/greedy_scs.py:442"),
    "sweep_compact": ("pgrc_tpu_torch/kernels/csrc/sweep_compact.cu",
                      "pgrc_tpu/overlap/greedy_scs.py:488"),
    "strand_rows": ("pgrc_tpu_torch/kernels/csrc/strand_rows.cu",
                    "pgrc_tpu/align/matcher.py:654, pgrc_tpu/core/packed.py:205"),
    "sweep_verify_links": ("pgrc_tpu_torch/kernels/csrc/sweep_verify.cu",
                           "pgrc_tpu/overlap/greedy_scs.py:866"),
}
# variants: JSON name -> (kernel, the launch counter of the path that runs it)
VARIANTS = {
    "verify_best.int64": ("verify_best", "verify_best.int64"),
    "index_kmer_hash.block": ("index_kmer_hash", "index_kmer_hash"),
    "index_kmer_hash.int64": ("index_kmer_hash", "index_kmer_hash.int64"),
    "join_carry.int64": ("join_carry", "join_carry.int64"),
    "strand_rows.take": ("strand_rows", "strand_rows.take"),
    "sweep_roll_entries.sharded": ("sweep_roll_entries", "sweep_roll_entries.sharded"),
    "sweep_pair_claim.sharded": ("sweep_pair_claim", "sweep_pair_claim.sharded"),
    "sweep_pair_claim.keys": ("sweep_pair_claim", "sweep_pair_claim.keys"),
}
# a variant that replaces another program than its kernel's main form
VARIANT_REPLACES = {"strand_rows.take": "pgrc_tpu/align/matcher.py:700",
                    "sweep_roll_entries.sharded": "pgrc_tpu/overlap/greedy_scs.py:243",
                    "sweep_pair_claim.sharded": "pgrc_tpu/overlap/greedy_scs.py:323",
                    "sweep_pair_claim.keys": "pgrc_tpu/overlap/greedy_scs.py:259"}
# the main path's int32 kernels: SE 200k and SE 2M launch each of them
MAIN_KERNELS = tuple(REPLACES)
MATCH_KERNELS = ("verify_best", "index_kmer_hash", "probe_kmer_hash", "join_carry",
                 "strand_rows")
SWEEP_KERNELS = ("sweep_full_hashes", "sweep_link_defaults", "sweep_init_links",
                 "sweep_roll_entries", "sweep_pair_claim", "sweep_compact",
                 "sweep_roll_entries.sharded", "sweep_pair_claim.sharded", "sweep_pair_claim.keys",
                 "sweep_verify_links")
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
# phase 8b: the repeat genome's row, and its input: reads, genome length
# (bench.py's, max(reads * 100 // 40, 200k)) and seed
BENCH_REPEAT = ("repeat 200k", 0.1339)  # label, pgrc_tpu's bits/base (BENCH_r05.json)
REPEAT_INPUT = (200_000, 500_000, 11)
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
# k-mer (multiply, subtract) — the same u32 hashes as the plain versions'
# Horner chain of k multiply-adds (kernel C takes this form, kernel B rolls
# its window a symbol at a time); E and F per entry of a sequential
# segmented max-scan (boundary compare, two selects, two maxima, the
# epilogue's test and select, its index), H per row of a count scan (the
# same count); D per entry (its side's two 64-bit multiply-adds at three
# 32-bit multiply-adds each, the symbol's shift and mask, the key's flip,
# and the count scan's 8); G as a chunked Horner, h = h * A^4 + T[byte],
# the same hashes as the kernel's chain of a multiply-add a symbol: per
# four symbols (a byte of codes) the byte's extraction (shift, and), its two
# table loads and two 64-bit multiply-adds with the entry as addend (three
# 32-bit multiply-adds each), and with N the nibble's extraction, two loads
# from a 16-entry table and two 64-bit adds (two each); per row the key's
# clamp and flip, 2; A per slot a read needs, the anchor's start (a 64-bit
# subtract, two) and its range test (three compares, two ands); G2 per sorted
# position its two key compares, and per tied position its two hash
# compares and the selects of succ, ovl and the flags; I per reverse
# complement lane (NOT, bit reversal, the pair swap's two shifts, two ands
# and or, the funnel shift), and with N its mask word's reversal and shift
# (half a lane each), the 16-bit spread (four shift-or-and steps and the
# last shift-or) and the and-not; J per word of a link's successor it
# compares (the funnel shift, the XOR, the mask's shift and select, the and,
# the or), in the 2-bit stream and the N mask alike, and per link its
# start and the test of its result
OPS_A_LANE, OPS_A_SLOT, OPS_HASH_SYM, OPS_HASH_KMER, OPS_SCAN = 8, 7, 4, 2, 8
OPS_D_ENTRY, OPS_G_BYTE, OPS_G_NIBBLE, OPS_G_ROW, OPS_G2_POS, OPS_G2_TIED = 18, 10, 8, 2, 2, 6
OPS_I_LANE, OPS_I_N_LANE = 8, 8 + 1 + 14 + 2
OPS_J_WORD, OPS_J_LINK = 6, 3
# the read lengths of kernel I's edge cases: every lane count's ends
STRAND_LENGTHS = (16, 17, 31, 32, 33, 37, 63, 64, 65, 80, 100, 128, 129, 150, 200, 255)
# launches of E and F held against one plain result on each input: a race
# in a look-back scan shows only now and then
CHECK_LAUNCHES = 10
# the card's spin before a timed window, ~40 ms at 1.98 GHz: longer than the
# host takes to queue the timed calls of one cuda_ms; a sharded round, whose
# host side takes longer than its device side at SE 200k, spins 16 times as
# long
QUEUE_CYCLES = 80_000_000
ROUND_QUEUE_CYCLES = 16 * QUEUE_CYCLES
# bytes read between two timed calls: twice the H100's 50 MB L2 cache, so
# no call finds in L2 the inputs or outputs that the one before left there
L2_EVICT_BYTES = 100 * 2**20
POS_MASK = (1 << 35) - 1
U32_MASK = 0xFFFFFFFF


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int, spin: int = QUEUE_CYCLES) -> float:
    """Mean milliseconds per call of fn() on the card, after one warm-up
    call: each call between its own pair of CUDA events, after a read of
    L2_EVICT_BYTES that evicts the L2 cache (a read, so the lines it leaves
    are clean and the timed call writes none of them back). The card first
    spins `spin` cycles, so the host has queued the timed calls before the
    first of them runs: the events time the device, not the Python launch
    path between short kernels (a fn that waits on the card is still timed
    with its waits). The buffer read is freed on return, so it adds nothing
    to the peak device memory of a later phase."""
    evict = torch.ones(L2_EVICT_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(spin)
    for start, end in events:
        evict.max()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


# max_abs_err of outputs whose shapes differ (a count or length differs)
SHAPE_ERR = 2**63 - 1


def max_abs_err(a, b) -> int:
    """Largest |a - b| over paired outputs, as integers (0 = bit-equal;
    SHAPE_ERR where two outputs differ in shape, or in number)."""
    if len(a) != len(b):
        return SHAPE_ERR
    return max((SHAPE_ERR if x.shape != y.shape else
                int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
                for x, y in zip(a, b)), default=0)


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
    native.get_lib()  # raises when it cannot be built or loaded
    say(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"nvcc: {(nvcc.stdout.strip().splitlines() or ['?'])[-1]} | "
        f"host native library loaded | "
        f"zstd {zstd} (stream coders are host code: their library versions "
        f"decide archive bytes)")
    return smi


def phase_build() -> None:
    from pgrc_tpu_torch.kernels import build

    from pgrc_tpu_torch.kernels import sweep

    b = build.build()
    require(build.lib().pgrc_sweep_record_chunk() == sweep.CHUNK,
            "csrc/sweep_record.cuh's chunk differs from kernels/sweep.py's CHUNK")
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


def verify_work(lanes, res, offs, pg_lanes, pg_len, L_, max_mis, n_verify, wide):
    """Bytes and operations of one verify_best call on these inputs (its
    arguments): the W lanes of each read; of each read's anchors (8 bytes a
    slot) the slots up to its n_verify-th in range, or all S where fewer
    are in range (a read stops there), counted as the 32-byte sectors that
    hold them; the offsets of those slots; the W+1 pg lanes of every
    verified window (at most the whole pg); (mis, pos) written once."""
    R, S = res.shape
    W = (L_ + 15) // 16
    cum = anchored(res, offs, pg_len, L_).cumsum(1)
    verified = int(cum[:, -1].clamp(max=n_verify).sum())
    # slots a read needs: up to and including its n_verify-th in range
    need = ((cum < n_verify).sum(1) + 1).clamp(max=S)
    first = torch.arange(R, dtype=torch.int64, device=res.device) * (S * 8)
    lo, hi = first // 32, (first + need * 8 - 1) // 32
    # rows lie back to back: a read may start in the sector the last one ended in
    sectors = int((hi - lo + 1).sum()) - int((lo[1:] == hi[:-1]).sum())
    pg_bytes = min(pg_lanes.numel() * 4, verified * (W + 1) * 4)
    nbytes = (R * W * 4 + 32 * sectors + int(need.max()) * 4 + pg_bytes
              + R * (1 + (8 if wide else 4)))
    return nbytes, verified * W * OPS_A_LANE + int(need.sum()) * OPS_A_SLOT


def anchored(res, offs, pg_len, L_):
    """[R, S] bool: the slots of the join's anchors `res` whose start (anchor
    - offset) is in range, as matcher.py:262-266 has it."""
    st = res - 1 - torch.tensor(offs, dtype=torch.int64, device=res.device)[None, :]
    return (res > 0) & (st >= 0) & (st <= pg_len - L_)


def check_verify(args, note, reps, timed=True):
    """Kernel A against its plain version on (read_lanes, res, offs,
    pg_lanes, pg_len, L, max_mis, n_verify, wide): every one of
    CHECK_LAUNCHES launches bit-equal."""
    from pgrc_tpu_torch.kernels import verify

    lanes, res, offs, pg_lanes, pg_len, L_, max_mis, n_verify, wide = args
    run = lambda: verify.verify_best(*args)
    run_plain = lambda: verify.verify_best_plain(
        lanes, *verify.probe_starts_plain(res, offs, pg_len, L_, wide), pg_lanes,
        max(pg_len - L_, 0), L_, max_mis, n_verify)
    want = run_plain()
    err = max(max_abs_err(run(), want) for _ in range(CHECK_LAUNCHES))
    found = int((want[0] != 255).sum())
    del want
    require(err == 0, f"verify_best {note}: kernel differs from its plain version")
    if not timed:
        return err, found
    return record("verify_best", run, run_plain, reps, note, *verify_work(*args), err=err)


def anchors(rng, R, offs, pg_len, L_, frac_in, near=None, lo=0):
    """A join's anchors res [R, S] (numpy int64, position + 1, 0 = none) at
    probe offsets `offs`: a share frac_in of slots in range (half of them
    within 2 of `near` [R], where given, the rest anywhere in [lo, pg_len -
    L]), the others a third without an anchor, a third starting before the
    pg (where the offset allows; else without) and a third past its last
    start."""
    S = len(offs)
    off = np.asarray(offs, dtype=np.int64)[None, :]
    hi = pg_len - L_
    st = rng.integers(lo, max(hi, lo) + 1, size=(R, S))
    if near is not None:
        st = np.where(rng.random((R, S)) < 0.5,
                      np.clip(near[:, None] + rng.integers(-2, 3, size=(R, S)), lo, max(hi, lo)),
                      st)
    res = st + 1 + off
    out = rng.random((R, S)) >= frac_in
    kind = rng.integers(0, 3, size=(R, S))
    before = np.where(off > 0, 1 + rng.integers(0, 1 << 40, size=(R, S)) % np.maximum(off, 1), 0)
    past = hi + 2 + off + rng.integers(0, 1000, size=(R, S))
    res = np.where(out & (kind == 0), 0, res)
    res = np.where(out & (kind == 1), before, res)
    return np.where(out & (kind == 2), past, res)


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
    """Kernel E against its plain version on (skey, perm, ipos, P): every
    one of CHECK_LAUNCHES launches bit-equal."""
    from pgrc_tpu_torch.kernels import join_carry as kj

    run = lambda: (kj.join_carry(*args),)
    run_plain = lambda: (kj.join_carry_plain(*args),)
    want = run_plain()
    err = max(max_abs_err(run(), want) for _ in range(CHECK_LAUNCHES))
    del want
    require(err == 0, f"{name} {note}: kernel differs from its plain version")
    if not timed:
        return err
    return record(name, run, run_plain, reps, note, *join_work(args[0], args[2], args[3]),
                  library=join_cummaxes(*args), err=err)


def pair_work(args, a_s_after, a_p_after):
    """Bytes and operations of kernel F on these inputs: keys and entry
    indices read once; a pair reads ids and p2 of its prefix and ids and h2
    of its suffix and clears one a_p; a link writes succ, ovl and a_s."""
    ks, a_s, a_p = args[0], args[7], args[8]
    paired = int((a_p & ~a_p_after).sum())
    links = int((a_s & ~a_s_after).sum())
    m = ks.numel()
    return 16 * m + 25 * paired + 9 * links, OPS_SCAN * m


def pair_cummaxes(args):
    """The two torch.cummax calls F replaces (the round's seg_start and first
    suffix), on these inputs, as the library yardstick."""
    ks, ent, ids = args[0], args[1], args[2]
    return cummaxes(ks, ent >= ids.numel())


def cummaxes(ks, is_suf):
    """The two torch.cummax calls of a round's pairing on sorted keys ks
    with their sides is_suf."""
    m = ks.numel()
    idx = torch.arange(m, dtype=torch.int64, device=ks.device)
    boundary = torch.ones((m,), dtype=torch.bool, device=ks.device)
    boundary[1:] = ks[1:] != ks[:-1]
    prev_is_suf = torch.zeros_like(is_suf)
    prev_is_suf[1:] = is_suf[:-1]
    seg_in = torch.where(boundary, idx, 0)
    fs_in = torch.where(is_suf & (~prev_is_suf | boundary), idx, -1)
    return lambda: (torch.cummax(seg_in, 0), torch.cummax(fs_in, 0))


def check_pair(name, args, note, reps, timed=True):
    """Kernel F against its plain version on one round's inputs (ks, ent,
    ids, p2, h2, succ_g, ovl_g, a_s, a_p, i, L): every one of
    CHECK_LAUNCHES launches bit-equal. The last four tensors are updated in
    place, so each launch runs on its own copies of them."""
    from pgrc_tpu_torch.kernels import sweep_pair_claim as kp

    head, outs, tail = args[:5], args[5:9], args[9:]

    def on_copies(fn):
        def run():
            mine = tuple(t.clone() for t in outs)
            fn(*head, *mine, *tail)
            return mine
        return run

    want = on_copies(kp.sweep_pair_claim_plain)()
    err = max(max_abs_err(on_copies(kp.sweep_pair_claim)(), want)
              for _ in range(CHECK_LAUNCHES))
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
    """A round's inputs to kernel F from row state: the active entries as
    kernel D writes them (its plain version's selection), then the round's
    sort (greedy_scs.round_order)."""
    from pgrc_tpu_torch.kernels import sweep
    from pgrc_tpu_torch.overlap import greedy_scs

    keys, ent, scratch = sweep.round_buffers(ids.numel(), ids.device)
    count = sweep.round_entries_plain(a_s, a_p, h, p, keys, ent, scratch)
    ks, ent = greedy_scs.round_order(keys, ent, count)
    N = int(ids.max()) + 1
    succ = torch.full((N,), -1, dtype=torch.int32, device=ids.device)
    ovl = torch.zeros((N,), dtype=torch.int32, device=ids.device)
    return (ks, ent, ids, p2, h2, succ, ovl, a_s, a_p, i, L)


def hashes_work(lanes, nmask, L, with_key):
    """Bytes and operations of kernel G on these inputs: the lane words that
    hold the row's L symbols (and its N-mask words) read once, two hashes
    (and the key) written; lanes [W+1, n], the sweep table's column-major
    layout."""
    n = lanes.shape[1]
    nbytes = n * (4 * -(-L // 16) + (4 * -(-L // 32) if nmask is not None else 0)
                  + (24 if with_key else 16))
    return nbytes, n * (-(-L // 4) * (OPS_G_BYTE + (OPS_G_NIBBLE if nmask is not None else 0))
                        + (OPS_G_ROW if with_key else 0))


def check_hashes(args, note, reps, timed=True):
    """Kernel G against its plain version on (lanes, nmask, L, with_key):
    every one of CHECK_LAUNCHES launches bit-equal."""
    from pgrc_tpu_torch.kernels import sweep_init as ki

    run = lambda: ki.sweep_full_hashes(*args)
    run_plain = lambda: ki.sweep_full_hashes_plain(*args)
    want = run_plain()
    err = max(max_abs_err(run(), want) for _ in range(CHECK_LAUNCHES))
    del want
    require(err == 0, f"sweep_full_hashes {note}: kernel differs from its plain version")
    if not timed:
        return err
    return record("sweep_full_hashes", run, run_plain, reps, note, *hashes_work(*args), err=err)


def links_work(ks, sidx, h0b, succ_after, a_p_after):
    """Bytes and operations of kernel G2 on these inputs: every sorted key
    read once; at each tied position (a neighbour's key equal) its row
    index and the row's h0b; the changed results written: succ, ovl and
    active_s of a row that links forward, active_p of one linked from
    behind. -> (bytes, operations, tied positions)."""
    n = ks.numel()
    same = ks[1:] == ks[:-1]
    tied = torch.zeros((n,), dtype=torch.bool, device=ks.device)
    tied[1:] |= same
    tied[:-1] |= same
    n_tied = int(tied.sum())
    fwd, back = int((succ_after >= 0).sum()), int((~a_p_after).sum())
    return (8 * n + 16 * n_tied + 9 * fwd + back,
            OPS_G2_POS * n + OPS_G2_TIED * n_tied, n_tied)


def check_links(args, note, reps, timed=True):
    """G2 (its fill kernel, then kernel G2 patching the filled state)
    against its plain version on (ks, sidx, h0b, L): every one of
    CHECK_LAUNCHES launches bit-equal. Timed: kernel G2 alone, patching
    one filled state again and again (the same values each time; the fill
    is timed on its own, `check_fill`), and that state then held bit-equal
    too."""
    from pgrc_tpu_torch.kernels import sweep_init as ki

    n, dev = args[0].numel(), args[0].device
    run = lambda: ki.sweep_init_links(*args, ki.link_defaults(n, dev))
    want = ki.sweep_init_links_plain(*args, ki.link_defaults_plain(n, dev))
    err = max(max_abs_err(run(), want) for _ in range(CHECK_LAUNCHES))
    require(err == 0, f"sweep_init_links {note}: kernel differs from its plain version")
    if not timed:
        return err
    mine = ki.link_defaults(n, dev)
    nbytes, ops, n_tied = links_work(*args[:3], want[0], want[3])
    say(f"[kernel] sweep_init_links {note}: {n_tied} tied positions of {n} "
        f"({n_tied / max(n, 1):.4f})")
    out = record("sweep_init_links", lambda: ki.sweep_init_links(*args, mine),
                 lambda: ki.sweep_init_links_plain(*args, mine), reps, note, nbytes, ops,
                 err=err)
    require(max_abs_err(mine, want) == 0,
            f"sweep_init_links {note}: the state patched while timed differs")
    return out


def check_fill(n, dev, note, reps):
    """G2's fill kernel (the rows' unlinked state) against its plain version
    (four torch.full calls) on n rows, timed: 10 bytes written a row."""
    from pgrc_tpu_torch.kernels import sweep_init as ki

    return record("sweep_link_defaults", lambda: ki.link_defaults(n, dev),
                  lambda: ki.link_defaults_plain(n, dev), reps, note, 10 * n, 0)


def check_init_links(lanes, nmask, L_, note):
    """greedy_scs._init_links (G, the stable sort, G2) on the card against
    its composition of plain versions on the CPU, over CHECK_LAUNCHES
    runs: every output bit-equal."""
    from pgrc_tpu_torch.overlap import greedy_scs

    want = greedy_scs._init_links(lanes.cpu(), None if nmask is None else nmask.cpu(), L_)
    err = max(max_abs_err(tuple(t.cpu() for t in greedy_scs._init_links(lanes, nmask, L_)),
                          want) for _ in range(CHECK_LAUNCHES))
    require(err == 0, f"_init_links {note}: the card's init differs from the CPU's")
    return err


def roll_outputs(fn, args):
    """A callable that runs kernel D (or its plain version) on its own copies
    of the round's hashes and buffers, -> (m, keys[:m], ent[:m], h, p, h2,
    p2) as tensors."""
    head, hashes, bufs = args[:6], args[6:10], args[10:13]

    def run():
        mine = tuple(t.clone() for t in hashes)
        keys, ent, scratch = (t.clone() for t in bufs)
        count = fn(*head, *mine, keys, ent, scratch)
        m = int(count)
        return (count, keys[:m], ent[:m], *mine)
    return run


def check_roll(args, note, reps, timed=True):
    """Kernel D against its plain version on one round's inputs (lanes,
    nmask, a_s, a_p, i, L, h, p, h2, p2, keys, ent, scratch), each launch
    on its own copies of what D writes: every one of CHECK_LAUNCHES
    launches bit-equal. Bytes: an entry reads and writes its side's two
    hashes and reads a lane word, an N-mask word and its flag; an active
    entry writes its key and index."""
    from pgrc_tpu_torch.kernels import sweep

    want = roll_outputs(sweep.sweep_roll_entries_plain, args)()
    err = max(max_abs_err(roll_outputs(sweep.sweep_roll_entries, args)(), want)
              for _ in range(CHECK_LAUNCHES))
    m = int(want[0])
    del want
    require(err == 0, f"sweep_roll_entries {note}: kernel differs from its plain version")
    if not timed:
        return err
    n, with_n = args[0].shape[1], args[1] is not None
    # timing: repeated calls roll one set of copies on (the same work)
    mine = tuple(t.clone() for t in args[6:13])
    return record("sweep_roll_entries", lambda: sweep.sweep_roll_entries(*args[:6], *mine),
                  lambda: sweep.sweep_roll_entries_plain(*args[:6], *mine), reps, note,
                  2 * n * (32 + 4 + (4 if with_n else 0) + 1) + 16 * m + 8,
                  2 * n * OPS_D_ENTRY, err=err)


def compact_outputs(fn, args):
    """A callable that runs kernel H (or its plain version) -> (counts, and
    the first k rows of each output array: of each column of the lanes and
    N mask)."""
    def run():
        outs, counts = fn(*args)
        k = int(counts[0])
        return (counts, *(o[..., :k] for o in outs if o is not None))
    return run


def check_compact(args, note, reps, timed=True):
    """Kernel H against its plain version on a table (lanes, nmask, ids, h,
    p, h2, p2, a_s, a_p): every one of CHECK_LAUNCHES launches bit-equal in
    its counts and kept rows. Bytes: both flags of every row, each kept
    row's arrays read and written once, three counts."""
    from pgrc_tpu_torch.kernels import sweep_compact as kc

    want = compact_outputs(kc.sweep_compact_plain, args)()
    err = max(max_abs_err(compact_outputs(kc.sweep_compact, args)(), want)
              for _ in range(CHECK_LAUNCHES))
    k = int(want[0][0])
    del want
    require(err == 0, f"sweep_compact {note}: kernel differs from its plain version")
    if not timed:
        return err
    n = args[2].numel()
    # a row's bytes: W+1 and Wn+1 words of the column-major lanes and N mask
    row = sum(a[..., 0].numel() * a.element_size() for a in args if a is not None)
    return record("sweep_compact", lambda: kc.sweep_compact(*args),
                  lambda: kc.sweep_compact_plain(*args), reps, note, 2 * n + 2 * k * row + 24,
                  OPS_SCAN * n, err=err)


def verify_links_work(lanes, nmask, L_, succ, ovl):
    """Bytes and operations of kernel J on these links: succ of every row;
    of each linked row its overlap o, the lane words that hold its last o
    symbols and its successor's first ceil(o / 16), 4 bytes each (each row
    of a link is read; the successor's words are a gather, counted at the
    4 bytes it uses), and with an N mask its words the same at 32 symbols a
    word; J's two counts written."""
    n = succ.numel()
    o = ovl[succ >= 0].to(torch.int64)
    s = L_ - o
    words = lambda per: int(((s % per + o + per - 1) // per + (o + per - 1) // per).sum())
    syms = (16,) + ((32,) if nmask is not None else ())
    succ_words = sum(int(((o + per - 1) // per).sum()) for per in syms)
    return (4 * n + 4 * o.numel() + 4 * sum(words(per) for per in syms) + 8,
            OPS_J_WORD * succ_words + OPS_J_LINK * o.numel())


def verify_links_outputs(fn, args):
    """A callable that runs kernel J (or its plain version) on its own
    copies of the links (lanes, nmask, L, succ, ovl, counts: J cuts in
    place) -> (succ, ovl, counts)."""
    def run():
        succ, ovl, counts = (t.clone() for t in args[3:6])
        fn(*args[:3], succ, ovl, counts)
        return succ, ovl, counts
    return run


def check_verify_links(args, note, reps, timed=True):
    """Kernel J against its plain version on (lanes, nmask, L, succ, ovl,
    counts), each launch on its own copies of the links: every one of
    CHECK_LAUNCHES launches bit-equal, the cut links and the counts. Timed:
    J checking one copy again and again, so from the second call on the
    links it kept (the links a sweep hands it are nearly all good); bytes
    and operations of those links."""
    from pgrc_tpu_torch.kernels import sweep_verify as kv

    want = verify_links_outputs(kv.sweep_verify_links_plain, args)()
    err = max(max_abs_err(verify_links_outputs(kv.sweep_verify_links, args)(), want)
              for _ in range(CHECK_LAUNCHES))
    checked, cut = want[2].tolist()
    require(err == 0, f"sweep_verify_links {note}: kernel differs from its plain version")
    say(f"[kernel] sweep_verify_links {note}: {checked} links checked, {cut} cut")
    if not timed:
        return err
    mine = want[:2] + (torch.zeros_like(want[2]),)
    return record("sweep_verify_links", lambda: kv.sweep_verify_links(*args[:3], *mine),
                  lambda: kv.sweep_verify_links_plain(*args[:3], *mine), reps, note,
                  *verify_links_work(*args[:3], *want[:2]), err=err)


def links_table(dev, n, rng, read_len=L, step=2.5, n_frac=0.05, bad_frac=0.02, n_vs_a=0.0):
    """A sweep table of n reads along a genome of step * n bases (a read
    every `step` bases: 40x at L 100 and 2.5), N in a share of rows, and
    their links as a full sweep leaves them: each read to the next along
    the genome where they overlap (duplicates at o = L), a share bad_frac
    of the links with the overlap shortened by 1-3 symbols and as many to a
    random read, and a share n_vs_a with an N in the read against an A in
    its successor inside the overlap (equal 2-bit codes); the rows in a
    random order, as an encode's reads come, so a successor is a random row
    -> (lanes, nmask, L, succ, ovl, counts), J's arguments, on `dev`."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.core import packed
    from pgrc_tpu_torch.kernels import sweep_verify

    glen = int(step * n) + read_len
    genome = rng.integers(0, 4, glen, dtype=np.uint8)
    starts = np.sort(rng.integers(0, glen - read_len + 1, n))
    codes = genome[starts[:, None] + np.arange(read_len)[None, :]]
    codes[rng.random(n) < n_frac, rng.integers(0, read_len)] = 4
    gap = np.diff(starts)
    succ = np.full(n, -1, np.int32)
    ovl = np.zeros(n, np.int32)
    linked = np.nonzero(gap < read_len)[0]
    succ[linked] = linked + 1
    ovl[linked] = read_len - gap[linked]
    short = rng.choice(linked, int(bad_frac * linked.size), replace=False)
    ovl[short] = np.maximum(ovl[short] - rng.integers(1, 4, short.size), 1)
    wild = rng.choice(linked, int(bad_frac * linked.size), replace=False)
    succ[wild] = rng.integers(0, n, wild.size)
    pairs = rng.choice(linked, int(n_vs_a * linked.size), replace=False)
    at = (rng.random(pairs.size) * ovl[pairs]).astype(np.int64)
    codes[pairs, read_len - ovl[pairs] + at] = 4
    codes[succ[pairs], at] = 0
    perm = rng.permutation(n)          # row r of the table holds read perm[r]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    codes, ovl = codes[perm], ovl[perm]
    succ = np.where(succ[perm] >= 0, inv[np.maximum(succ[perm], 0)], -1).astype(np.int32)
    lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes), dev)
    on = lambda a: torch.from_numpy(a).to(dev)
    return (lanes, nmask, read_len, on(succ), on(ovl),
            torch.zeros(sweep_verify.COUNTS, dtype=torch.int32, device=dev))


def sweep_table(dev, n, rng, act, n_frac=0.05, dup_frac=0.1, read_len=L):
    """A sweep table of n random reads of read_len symbols (a share
    duplicated, N in a share of rows), random 64-bit hashes and active flags
    with probability act: (lanes, nmask, ids, h, p, h2, p2, a_s, a_p), the
    lanes and N mask column-major, as find_overlaps uploads them."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.core import packed

    codes = rng.integers(0, 4, size=(n, read_len), dtype=np.uint8)
    dup = np.nonzero(rng.random(n) < dup_frac)[0]
    codes[dup] = codes[rng.integers(0, n, dup.size)]
    codes[rng.random(n) < n_frac, rng.integers(0, read_len)] = 4
    lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes), dev)
    ids = torch.from_numpy(np.sort(rng.choice(3 * n, n, replace=False)).astype(np.int32)).to(dev)
    hs = [state.hashes_to_device(rng.integers(0, 2**64, n, dtype=np.uint64), dev)
          for _ in range(4)]
    flags = [torch.from_numpy(rng.random(n) < act).to(dev) for _ in range(2)]
    return (lanes, nmask, ids, *hs, *flags)


def roll_args(table, i=3, L_=L):
    """Kernel D's arguments for round i on a table of L_-symbol reads, with
    fresh buffers."""
    from pgrc_tpu_torch.kernels import sweep

    lanes, nmask, ids, h, p, h2, p2, a_s, a_p = table
    return (lanes, nmask, a_s, a_p, i, L_, h, p, h2, p2,
            *sweep.round_buffers(ids.numel(), ids.device))


def links_args(lanes, nmask, L_=L):
    """Kernel G2's arguments on these rows of L_ symbols: G's key sorted
    stably, as the init does."""
    from pgrc_tpu_torch.kernels import sweep_init

    h0, h0b, key = sweep_init.sweep_full_hashes_plain(lanes, nmask, L_, with_key=True)
    ks, sidx = torch.sort(key, stable=True)
    return ks, sidx, h0b, L_


def synthetic_links_args(dev, runs, hb_of=None):
    """Kernel G2's arguments from key runs: `runs` the lengths of the runs
    of equal sorted keys, in order; the rows a random permutation; h0b per
    sorted position from hb_of(position, run) (default: the run's number,
    so a run's rows agree), scattered to the rows."""
    rng = np.random.default_rng(sum(runs) + len(runs))
    run_of = np.repeat(np.arange(len(runs)), runs)
    n = run_of.size
    ks = np.sort(rng.choice(1 << 62, len(runs), replace=False))[run_of] - (1 << 61)
    sidx = rng.permutation(n)
    hb_s = run_of.astype(np.int64) if hb_of is None else hb_of(np.arange(n), run_of)
    h0b = np.empty(n, np.int64)
    h0b[sidx] = hb_s
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)
    return on(ks), on(sidx), on(h0b), L


def sweep_edge_cases(dev) -> int:
    """Kernels D and H where a compacting count scan goes wrong (no active
    entry, all active, one active entry at the last position, a length off
    the tile, more tiles than one 32-tile look-back window), H also at its
    own tile (n at the tile and one off, a ragged last tile under the
    asynchronous copies, the rows kept before a tile at each residue mod 4,
    where its 16-byte stores start their runs, with and without N, and rows
    too wide for its tile, which it halves), D, D's sharded form and H on
    a compacted view (every array the head rows of wider storage, the
    lanes' column stride past the rows), G, D and H on columns off 16-byte
    alignment (an odd column stride), and G and G2 at their edges
    (one row, rows off the block, more tiles than the resident blocks take
    in one pass, L off the byte and the lane, 17 lanes, rows all N, one
    long run of equal keys). Each case over CHECK_LAUNCHES launches
    bit-equal; -> the number of cases."""
    from pgrc_tpu_torch import kernels, state
    from pgrc_tpu_torch.core import packed
    from pgrc_tpu_torch.kernels import sweep_compact

    T = kernels.scan_tile()
    T_H = sweep_compact.tile()
    rng = np.random.default_rng(987)
    cases = []
    for label, n, act in (("m = 0", 3 * T + 5, 0.0), ("all active", 5 * T, 1.0),
                          ("n off the tile", T // 2 + 777, 0.5),
                          ("100 tiles, past one look-back window", 50 * T, 0.9)):
        table = sweep_table(dev, n, rng, act)
        check_roll(roll_args(table), label, 0, timed=False)
        check_compact(table, label, 0, timed=False)
        cases += [f"D {label}", f"H {label}"]
    # a compacted table, as find_overlaps keeps it after a segment end:
    # every array a view of wider storage at its head rows, the lanes' and
    # N mask's column stride past the rows
    from pgrc_tpu_torch.kernels import sweep

    kept = 2 * T + 333
    view = tuple(None if v is None else v[..., :kept]
                 for v in sweep_table(dev, 3 * T + 100, rng, 0.7))
    require(view[1] is not None and min(view[0].stride(0), view[1].stride(0)) > kept,
            "the compacted view's column stride is not past its rows")
    label = f"a compacted view ({kept} rows, column stride {view[0].stride(0)})"
    check_roll(roll_args(view), label, 0, timed=False)
    check_roll_records((*roll_args(view)[:10], view[2], *sweep.record_buffers(kept, dev)),
                       label, 0, timed=False)
    check_compact(view, label, 0, timed=False)
    cases += [f"D {label}", f"D sharded {label}", f"H {label}"]
    # the same rows but two, copied with a column stride of their odd count:
    # columns off 16-byte alignment, which G and H stage by 4-byte copies
    odd = tuple(None if v is None else v[..., :kept - 2].contiguous() for v in view)
    require(odd[0].stride(0) % 4 != 0, "the copied table's columns are 16-byte aligned")
    label = f"columns off 16-byte alignment (column stride {odd[0].stride(0)})"
    check_hashes((odd[0], odd[1], L, True), label, 0, timed=False)
    check_roll(roll_args(odd), label, 0, timed=False)
    check_compact(odd, label, 0, timed=False)
    cases += [f"G {label}", f"D {label}", f"H {label}"]
    table = list(sweep_table(dev, 3 * T + 1, rng, 0.0))
    table[7][-1] = True            # the last suffix alone: the last entry
    check_roll(roll_args(table), "one active entry, the last", 0, timed=False)
    check_compact(table, "one kept row, the last", 0, timed=False)
    cases += ["D one active entry, the last", "H one kept row, the last"]
    for label, n, n_frac in ((f"n = H's tile - 1 ({T_H - 1})", T_H - 1, 0.0),
                             (f"n = H's tile ({T_H}), N", T_H, 0.05),
                             (f"n = H's tile + 1 ({T_H + 1})", T_H + 1, 0.0),
                             ("a ragged last tile (333 rows), N", 5 * T_H + 333, 0.05)):
        check_compact(sweep_table(dev, n, rng, 0.5, n_frac=n_frac), label, 0, timed=False)
        cases.append(f"H {label}")
    for r in range(4):
        table = sweep_table(dev, 3 * T_H + 5, rng, 0.45, n_frac=0.05 if r % 2 else 0.0)
        keep = table[7] | table[8]
        dropped = torch.nonzero(~keep[:T_H]).squeeze(1)
        table[8][dropped[:(r - int(keep[:T_H].sum())) % 4]] = True
        require(int((table[7] | table[8])[:T_H].sum()) % 4 == r, "H base residue not set")
        label = f"output base {r} mod 4 from the second tile, N {table[1] is not None}"
        check_compact(table, label, 0, timed=False)
        cases.append(f"H {label}")
    check_compact(sweep_table(dev, 3 * T_H + 7, rng, 0.6, read_len=496),
                  "L 496 with N, 234-byte rows (the tile halved to fit)", 0, timed=False)
    cases.append("H rows too wide for its tile")
    for label, n, n_frac in (("one row", 1, 0.0), ("rows off the block", 4096 + 77, 0.05)):
        table = sweep_table(dev, n, rng, 1.0, n_frac=n_frac)
        check_hashes((table[0], table[1], L, True), label, 0, timed=False)
        check_links(links_args(table[0], table[1]), label, 0, timed=False)
        check_init_links(table[0], table[1], L, label)
        cases += [f"G {label}", f"G2 {label}", f"init {label}"]
    table = sweep_table(dev, 400_003, rng, 1.0, n_frac=0.0, dup_frac=0.0)
    check_hashes((table[0], None, L, True), "400,003 rows (blocks walk several tiles)", 0,
                 timed=False)
    cases.append("G more tiles than resident blocks")
    table = sweep_table(dev, 20_000, rng, 1.0, dup_frac=0.0)
    same = packed.cols_copy(table[0][:, :1].expand(-1, 20_000))   # one read 20,000 times
    check_links(links_args(same, None), "one run of 20,000 equal keys", 0, timed=False)
    check_init_links(same, None, L, "one run of 20,000 equal reads")
    cases += ["G2 one run of equal keys", "init one run of equal reads"]
    # G2 where only tied positions work: a warp's or a block's edge inside a
    # pair, the first and last positions, h0b changing inside a run
    for label, runs, hb_of in (
            ("no tie", [1] * 5000, None),
            ("every position tied (runs of 2)", [2] * 3000, None),
            ("every position tied (runs of 3 and 40)", [3, 40] * 300, None),
            ("equal keys with h0b changing every 3 positions of a run",
             [7, 300, 1, 45, 2, 96] * 20, lambda pos, run: run * 4 + (pos // 3) % 2),
            ("tied pairs across a warp edge (31|32) and a block edge (255|256)",
             [1] * 31 + [2] + [1] * 222 + [2] + [1] * 100, None),
            ("a tie at the first and at the last position", [2] + [1] * 1000 + [2], None)):
        check_links(synthetic_links_args(dev, runs, hb_of), label, 0, timed=False)
        cases.append(f"G2 {label}")
    for read_len, n_sym, with_key in ((37, 5, False), (99, 5, True), (99, 4, False),
                                      (150, 5, True), (150, 4, False),
                                      (255, 5, True), (255, 4, False)):
        codes = rng.integers(0, n_sym, size=(5000, read_len), dtype=np.uint8)
        lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes), dev)
        label = f"L {read_len} ({lanes.shape[0]} lanes), N {nmask is not None}, key {with_key}"
        check_hashes((lanes, nmask, read_len, with_key), label, 0, timed=False)
        cases.append(f"G {label}")
    codes = rng.integers(0, 5, size=(3000, L), dtype=np.uint8)
    codes[::3] = 4                 # every third row all N
    lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes), dev)
    check_hashes((lanes, nmask, L, True), "rows all N", 0, timed=False)
    cases.append("G rows all N")
    # J: lane and N-mask words off their ends (L 37, 64, 150, 255), rows off
    # the block, one row, N against A inside overlaps (only the N mask
    # tells them apart), links a third bad, and a table that is the head of
    # wider storage (its column stride past its rows)
    for label, n, read_len, kw in (
            ("L 37 with N", 5000, 37, {}), ("L 64, no N", 5000, 64, {"n_frac": 0.0}),
            ("L 64, rows off the block", 4097, 64, {}), ("L 150 with N", 5000, 150, {}),
            ("L 255 with N", 3000, 255, {"step": 10.0}), ("one row", 1, L, {}),
            ("N against A in 20% of the links", 20_000, L, {"n_vs_a": 0.2}),
            ("a third of the links bad", 20_000, L, {"bad_frac": 0.17})):
        args = links_table(dev, n, rng, read_len, **kw)
        check_verify_links(args, label, 0, timed=False)
        cases.append(f"J {label}")
    lanes, nmask, L_, succ, ovl, counts = links_table(dev, 7000, rng)
    wide = [packed.empty_cols(t.shape[0], 7000 + 333, dev) for t in (lanes, nmask)]
    for w, t in zip(wide, (lanes, nmask)):
        w[:, :7000] = t
    view = tuple(w[:, :7000] for w in wide)
    require(view[0].stride(0) > 7000 + 32, "the wider table's column stride is not past its rows")
    check_verify_links((*view, L_, succ, ovl, counts), "the head of wider storage", 0,
                       timed=False)
    cases.append("J the head of wider storage")
    return len(cases)


def scan_edge_cases(dev) -> int:
    """Kernels E and F on inputs that break a look-back scan that is wrong at
    its edges, sized from the tile T; -> the number of cases, each
    bit-equal to the plain version over CHECK_LAUNCHES launches."""
    from pgrc_tpu_torch import kernels
    from pgrc_tpu_torch.align import matcher
    from pgrc_tpu_torch.kernels import kmer_hash

    T = kernels.scan_tile()
    cases = []
    rng = np.random.default_rng(321)
    on = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(dev)

    def join(label, ihash, ipos, hashes, wide=False):
        ih = on(np.asarray(ihash, np.uint32).view(np.int32), np.int32)
        ip = on(ipos, np.int64 if wide else np.int32)
        hs = on(np.asarray(hashes, np.uint32).view(np.int32), np.int32)
        keys = torch.cat([kmer_hash.index_keys(ih, ip), kmer_hash.probe_keys(hs)])
        skey, perm = matcher.join_sort(keys, ip.numel(), hs.numel())
        check_join("join_carry", (skey, perm, ip, hs.numel()), label, 0, timed=False)
        say(f"[kernel] join_carry {label}: m2={skey.numel()} bit-equal")
        cases.append(label)

    M, P = 3000, 150 * T
    join("one run over all entries (~150 tiles: past one 32-tile look-back window)",
         np.full(M, 77), rng.permutation(10 * M)[:M], np.full((P // 10, 10), 77))
    join("runs of one entry", rng.permutation(1 << 24)[:50_000], rng.integers(0, 1 << 30, 50_000),
         rng.permutation(1 << 24)[:60_000].reshape(-1, 12), wide=True)
    join("runs ending at tile edges", np.repeat(np.arange(64) * 7, T // 4),
         rng.permutation(1 << 22)[:64 * T // 4],
         np.repeat(np.arange(64) * 7, 3 * T // 4).reshape(-1, 16))
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

    n = 40 * T
    pair(f"one run over all entries ({2 * n // T} tiles), partners {n // T} tiles back",
         n, np.zeros(n), np.zeros(n))
    n = 100_000
    pair("runs of one entry", n, 2 * rng.permutation(n), 2 * rng.permutation(n) + 1)
    pair("runs ending at tile edges", 32 * T, np.arange(32 * T) // (T // 2),
         np.arange(32 * T) // (T // 2))
    pair("more suffixes than prefixes", n, rng.integers(0, 50, n) * 3, rng.integers(0, 10, n) * 3,
         act=0.8, ids=np.sort(rng.choice(3 * n, n, replace=False)))
    pair("m = 1", 1, np.zeros(1), np.zeros(1), a_s=np.zeros(1, bool), a_p=np.ones(1, bool))
    pair("m off the tile", 77_777, rng.integers(0, 5_000, 77_777), rng.integers(0, 5_000, 77_777),
         act=0.7)
    return len(cases)


def verify_edge_cases(dev) -> int:
    """Kernel A (a thread a read, 128 a block; anchors read 8 at a time;
    windows verified in batches of 6 up to W 8, of 4 from W 9, each window
    read as the aligned 16-byte chunks of the pg that hold it) where it
    can go wrong: every window width (W 1, 7 at L 100 and 112, 8 and 9 on
    either side of the batch's switch, 10 at L 150, 16 with and without a
    full last lane), more slots than a 64-bit mask, n_verify 1, 6 and 12
    (a batch fills inside an 8-anchor step), rows with fewer in-range slots than
    n_verify and rows with none, a pg shorter than the read, start residues
    0 and 15, chunks at the pg's first and last lane, equal mismatches at
    two starts (the lower wins), int64 starts from 2^31 + 48, and R off
    the block and off a warp. Each case over CHECK_LAUNCHES launches
    bit-equal; -> the number of cases."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.core import packed

    rng = np.random.default_rng(777)
    cases = []

    def sampled(pg, L_, near):
        reads = pg[near[:, None] + np.arange(L_)[None, :]].copy()
        err = rng.random(reads.shape) < 0.03
        reads[err] = (reads[err] + 1) % 4
        return state.lanes_to_device(*packed.pack_lanes(reads), dev)[0]

    def case(label, pg_lanes, pg_len, L_, lanes, offs, res, n_verify=6, max_mis=254,
             wide=False):
        args = (lanes, torch.from_numpy(res.astype(np.int64)).to(dev), tuple(int(o) for o in offs),
                pg_lanes, pg_len, L_, max_mis, n_verify, wide)
        _, found = check_verify(args, label, 0, timed=False)
        say(f"[kernel] verify_best {label}: R={lanes.shape[0]} S={len(offs)} "
            f"n_verify={n_verify}, {found} rows matched, bit-equal")
        cases.append(label)

    pg = rng.integers(0, 4, size=16 * 4000 + 7, dtype=np.uint8)
    pg_lanes = state.pg_lanes_to_device(pg, dev)
    R = 4096 + 37                   # off the block (128 threads) and off a warp
    for L_ in (16, 100, 112, 113, 129, 150, 255, 256):
        near = rng.integers(0, pg.size - L_ + 1, R)
        offs = tuple(range(0, max(L_ - 24, 1), 4))[:23]
        case(f"L {L_} (W {(L_ + 15) // 16})", pg_lanes, pg.size, L_, sampled(pg, L_, near),
             offs, anchors(rng, R, offs, pg.size, L_, 0.7, near))
    near = rng.integers(0, pg.size - L + 1, R)
    lanes = sampled(pg, L, near)
    offs130 = tuple(j % 77 for j in range(130))
    case("S 130, 5% in range (a read walks many 8-anchor steps)", pg_lanes, pg.size, L, lanes,
         offs130, anchors(rng, R, offs130, pg.size, L, 0.05, near))
    case("S 130, n_verify 12 (a batch of 6 fills inside an 8-anchor step)", pg_lanes, pg.size, L,
         lanes, offs130, anchors(rng, R, offs130, pg.size, L, 0.5, near), n_verify=12)
    offs8 = tuple(range(0, 64, 8))
    res = anchors(rng, R, offs8, pg.size, L, 0.15, near)
    res[::3] = 0
    case("fewer in-range slots than n_verify, a third of the rows with none", pg_lanes,
         pg.size, L, lanes, offs8, res)
    offs = probe_offsets_l(L)
    case("n_verify 1, max_mis 33", pg_lanes, pg.size, L, lanes, offs,
         anchors(rng, R, offs, pg.size, L, 0.7, near), n_verify=1, max_mis=33)
    case("wide (int64 starts) on a short pg", pg_lanes, pg.size, L, lanes, offs,
         anchors(rng, R, offs, pg.size, L, 0.7, near), wide=True)
    for r_label, R_ in (("one row", 1), ("R 37 (off a block and a warp)", 37)):
        case(r_label, pg_lanes, pg.size, L, lanes[:R_], offs,
             anchors(rng, R_, offs, pg.size, L, 0.7, near[:R_]))
    # start residues 0 and 15
    st = rng.integers(0, pg.size - L + 1, (R, len(offs)))
    st = np.minimum(st - st % 16 + np.where(rng.random(st.shape) < 0.5, 0, 15), pg.size - L)
    st[:, 0] = near
    case("start residues 0 and 15", pg_lanes, pg.size, L, lanes, offs,
         st + 1 + np.asarray(offs)[None, :])
    # chunks at the pg's first lane: starts 0..23
    st = rng.integers(0, 24, (R, len(offs)))
    case("windows on the pg's first lane", pg_lanes, pg.size, L, sampled(pg, L, st[:, 0]), offs,
         st + 1 + np.asarray(offs)[None, :])
    # windows on the pg's last lane: pg_len 16n + 7, starts up to pg_len - L
    near_end = pg.size - L - rng.integers(0, 24, R)
    st = pg.size - L - rng.integers(0, 24, (R, len(offs)))
    case("windows on the pg's last lane", pg_lanes, pg.size, L, sampled(pg, L, near_end), offs,
         st + 1 + np.asarray(offs)[None, :])
    # a pg shorter than the read: no slot is in range
    short = rng.integers(0, 4, size=50, dtype=np.uint8)
    case("pg_len 50 < L", state.pg_lanes_to_device(short, dev), short.size, L, lanes, offs,
         anchors(rng, R, offs, short.size, L, 0.7))
    # equal mismatches at two starts: window a copied to b > a, the slot of b
    # first; the lower start a wins
    n_eq = 150
    pg2 = rng.integers(0, 4, size=70_000, dtype=np.uint8)
    a = np.arange(n_eq) * 200 + rng.integers(0, 16, n_eq)
    b = 30_000 + np.arange(n_eq) * 200 + rng.integers(0, 16, n_eq)
    for i in range(n_eq):
        pg2[b[i]:b[i] + L] = pg2[a[i]:a[i] + L]
    res = np.zeros((n_eq, len(offs)), np.int64)
    res[:, 0] = b + 1 + offs[0]
    res[:, 1] = a + 1 + offs[1]
    case("equal mismatches at two starts", state.pg_lanes_to_device(pg2, dev), pg2.size, L,
         sampled(pg2, L, a), offs, res)
    # int64 starts past 2^31 on a 2^31-symbol pg of random lanes
    n_big = (1 << 27) + 4099
    big = torch.randint(-(1 << 31), (1 << 31) - 1, (n_big + 1,), dtype=torch.int32, device=dev)
    big[-1] = 0
    big_len = 16 * n_big - 9
    rand_lanes = torch.randint(-(1 << 31), (1 << 31) - 1, (R, (L + 15) // 16 + 1),
                               dtype=torch.int32, device=dev)
    case("int64 starts from 2^31 + 48", big, big_len, L, rand_lanes, offs,
         anchors(rng, R, offs, big_len, L, 0.7, lo=PAST_INT32 + 48), wide=True)
    del big
    return len(cases)


def probe_offsets_l(L_, k=32):
    """The matcher's probe offsets of a read of L_ symbols (k 32, step 3)."""
    from pgrc_tpu_torch.align.matcher import probe_offsets

    return tuple(probe_offsets(L_, k, 3))


def hash_edge_cases(dev) -> int:
    """Kernels B and C where a tiled rolling or prefix hash goes wrong: the
    ragged tile, one entry, the pg's last lane, block starts, positions
    past 2^31, every k and k1 the matcher uses, offsets at both ends of the
    lanes, one row, more offsets than threads. Each case over
    CHECK_LAUNCHES launches bit-equal to the plain version; -> the number
    of cases."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.kernels import kmer_hash as kh

    rng = np.random.default_rng(654)
    cases = []

    def check(label, run, run_plain):
        want = run_plain()
        err = max(max_abs_err(run(), want) for _ in range(CHECK_LAUNCHES))
        require(err == 0, f"{label}: kernel differs from its plain version")
        cases.append(label)

    def b(label, pg, pg_len, k, k1, m, lane_off=0, wide=False):
        args = (pg, k, k1, pg_len, m, lane_off, wide)
        check(f"index_kmer_hash {label}", lambda: kh.index_kmer_hash(*args),
              lambda: kh.index_kmer_hash_plain(*args))

    pg_len = 16 * 50_000 + 7                      # not a multiple of 16
    pg = state.pg_lanes_to_device(rng.integers(0, 4, pg_len, dtype=np.uint8), dev)
    n_lanes = pg.numel() - 1
    b("m off the tile", pg, pg_len, 32, 4, 3 * 4096 + 777)
    b("m = 1, lane_off 5", pg, pg_len, 32, 4, 1, 5)
    for k in (24, 32, 37, 40):
        for k1 in (2, 4, 8):
            lane_off = n_lanes - 3001              # to the pg's end, off any alignment
            b(f"k {k} k1 {k1}, lanes {lane_off}..{n_lanes} (the last window crosses the "
              f"pg's last lane)", pg, pg_len, k, k1, (n_lanes - lane_off) * 16 // k1, lane_off)
    # a 2^31-symbol pg as random lanes: int64 positions past 2^31
    n_big = (1 << 27) + 4099
    big = torch.randint(-(1 << 31), (1 << 31) - 1, (n_big + 1,), dtype=torch.int32, device=dev)
    big[-1] = 0
    lane_off = (1 << 27) + 3
    b("int64 positions from 2^31 + 48, lane_off > 0", big, 16 * n_big - 9, 40, 4,
      (n_big - lane_off) * 4, lane_off, wide=True)
    del big

    def c(label, lanes, offs, k):
        check(f"probe_kmer_hash {label}", lambda: (kh.probe_kmer_hash(lanes, offs, k),),
              lambda: (kh.probe_kmer_hash_plain(lanes, offs, k),))

    W1 = (L + 15) // 16 + 1
    lanes = torch.randint(-(1 << 31), (1 << 31) - 1, (4096 + 37, W1), dtype=torch.int32,
                          device=dev)
    c("a single row, offsets 0 and 16*(W+1) - k", lanes[:1], [0, 16 * W1 - 32], 32)
    c("rows off the tile, offsets 0 and 16*(W+1) - k", lanes, [0, 1, 16 * W1 - 40], 40)
    for k in (24, 37):
        c(f"k {k}, the matcher's offsets", lanes[:2000 + 13], list(range(0, L - k + 1, 3)), k)
    c("130 offsets (more than a block's threads)", lanes[:300],
      [j % (16 * W1 - 23) for j in range(130)], 24)
    return len(cases)


def strand_work(lanes, nmask, L_, rows):
    """Bytes and operations of one strand_rows call on these inputs: each
    row it takes read once (W+1 lanes, the Wn N-mask words where there is a
    mask; a row taken twice is read once), its row ids, 2R rows of W+1
    lanes written; the operations of R reverse-complement rows."""
    W, Wn = (L_ + 15) // 16, (L_ + 31) // 32
    R = lanes.shape[0] if rows is None else rows.numel()
    read = R if rows is None else int(torch.unique(rows).numel())
    nbytes = (read * ((W + 1) + (Wn if nmask is not None else 0)) * 4 + 2 * R * (W + 1) * 4
              + (8 * R if rows is not None else 0))
    return nbytes, R * W * (OPS_I_N_LANE if nmask is not None else OPS_I_LANE)


def check_strand(args, note, reps, timed=True, library=None):
    """Kernel I against its plain version on (lanes, nmask, L, rows): every
    one of CHECK_LAUNCHES launches bit-equal."""
    from pgrc_tpu_torch.kernels import strand_rows as sr

    run = lambda: (sr.strand_rows(*args),)
    run_plain = lambda: (sr.strand_rows_plain(*args),)
    want = run_plain()
    err = max(max_abs_err(run(), want) for _ in range(CHECK_LAUNCHES))
    del want
    require(err == 0, f"strand_rows {note}: kernel differs from its plain version")
    if not timed:
        return err
    return record("strand_rows", run, run_plain, reps, note, *strand_work(*args),
                  library=library, err=err)


def strand_take(lanes, nmask, L_, rows):
    """The pass-2 take's library yardstick: one torch.index_select of the
    same 2R rows from pass 1's rows (kernel I's prep form, made once here)."""
    from pgrc_tpu_torch.kernels import strand_rows as sr

    fr = sr.strand_rows(lanes, nmask, L_)
    idx = torch.cat([rows, rows + lanes.shape[0]])
    return lambda: torch.index_select(fr, 0, idx)


def strand_edge_cases(dev) -> int:
    """Kernel I in both forms at every lane count's ends (STRAND_LENGTHS),
    rows off its block, with no N, N in 3% of the symbols, and rows all N
    with N at a read's first and last position; a take that is shuffled
    and repeats rows, one row, one row taken 3000 times, and random lanes
    and masks (the pad lane and the bits past L set). Each case over
    CHECK_LAUNCHES launches bit-equal; -> the number of cases."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.core import packed

    rng = np.random.default_rng(987)
    cases = 0

    def both(label, lanes, nmask, L_, rows):
        nonlocal cases
        check_strand((lanes, nmask, L_, None), f"{label}, every row", 0, timed=False)
        check_strand((lanes, nmask, L_, rows), f"{label}, a take of {rows.numel()} rows", 0,
                     timed=False)
        cases += 2

    for i, L_ in enumerate(STRAND_LENGTHS):
        n = 4096 + 37 + i          # n (W + 1) threads, off the 256-thread block
        codes = rng.integers(0, 4, size=(n, L_), dtype=np.uint8)
        kind = ("no N", "N in 3%", "rows all N, N first and last")[i % 3]
        if i % 3 == 1:
            codes[rng.random(codes.shape) < 0.03] = 4
        elif i % 3 == 2:
            codes[::7] = 4
            codes[1::7, 0] = 4
            codes[2::7, -1] = 4
        lanes, nmask = state.lanes_to_device(*packed.pack_lanes(codes), dev)
        take = np.concatenate([rng.choice(n, n // 3, replace=False), [5, 5, 5, n - 1]])
        rows = torch.from_numpy(rng.permutation(take)).to(dev)
        both(f"L {L_}, {n} reads, {kind}", lanes, nmask, L_, rows)
    codes = rng.integers(0, 5, size=(1, 100), dtype=np.uint8)
    codes[0, [0, 99]] = 4
    lanes, nmask = state.lanes_to_device(*packed.pack_lanes(codes), dev)
    both("L 100, one read with N", lanes, nmask, 100, torch.zeros(1, dtype=torch.int64,
                                                                  device=dev))
    lanes = torch.randint(-(1 << 31), (1 << 31) - 1, (3001, 8), dtype=torch.int32, device=dev)
    nmask = torch.randint(-(1 << 31), (1 << 31) - 1, (3001, 5), dtype=torch.int32, device=dev)
    both("L 100, random lanes and masks", lanes, nmask, 100,
         torch.full((3000,), 1234, dtype=torch.int64, device=dev))
    return cases


def records_outputs(fn, args):
    """A callable that runs kernel D's sharded form (or its plain version)
    on its own copies of the round's hashes, send buffer and scratch -> (the
    counts (m, prefixes), the send buffer, h, p, h2, p2). Both start from
    the same buffer, so the words past the entries compare too."""
    head, hashes, ids, bufs = args[:6], args[6:10], args[10], args[11:13]

    def run():
        mine = tuple(t.clone() for t in hashes)
        recs, scratch = (t.clone() for t in bufs)
        counts = fn(*head, *mine, ids, recs, scratch)
        return (counts, recs, *mine)
    return run


def check_roll_records(args, note, reps, timed=True):
    """Kernel D's sharded form against its plain version on one round's
    inputs (lanes, nmask, a_s, a_p, i, L, h, p, h2, p2, ids, recs, scratch),
    each launch on its own copies of what it writes: every one of
    CHECK_LAUNCHES launches bit-equal. Bytes: as D, and an active entry
    reads its row's id and writes its 8-byte key and 16-byte payload."""
    from pgrc_tpu_torch.kernels import sweep

    want = records_outputs(sweep.sweep_roll_records_plain, args)()
    err = max(max_abs_err(records_outputs(sweep.sweep_roll_records, args)(), want)
              for _ in range(CHECK_LAUNCHES))
    m = int(want[0][0])
    del want
    require(err == 0, f"sweep_roll_entries.sharded {note}: kernel differs from its plain "
            f"version")
    if not timed:
        return err
    n, with_n = args[0].shape[1], args[1] is not None
    mine = tuple(t.clone() for t in args[6:10]) + (args[10],) + tuple(
        t.clone() for t in args[11:13])
    return record("sweep_roll_entries.sharded",
                  lambda: sweep.sweep_roll_records(*args[:6], *mine),
                  lambda: sweep.sweep_roll_records_plain(*args[:6], *mine), reps, note,
                  2 * n * (32 + 4 + (4 if with_n else 0) + 1) + 28 * m + 16,
                  2 * n * OPS_D_ENTRY, err=err)


def check_keys(args, note, reps, timed=True):
    """The sharded round's key layout against its plain version on
    (gathered, counts, m): every one of CHECK_LAUNCHES launches bit-equal.
    Bytes: each entry's key read once and written once, and the counts;
    no one library call lays the keys out from the gathered buffer."""
    from pgrc_tpu_torch.kernels import sweep_pair_claim as kp

    want = (kp.sharded_keys_plain(*args),)
    err = max(max_abs_err((kp.sharded_keys(*args),), want) for _ in range(CHECK_LAUNCHES))
    del want
    require(err == 0, f"sweep_pair_claim.keys {note}: kernel differs from its plain version")
    if not timed:
        return err
    m = args[2]
    return record("sweep_pair_claim.keys", lambda: (kp.sharded_keys(*args),),
                  lambda: (kp.sharded_keys_plain(*args),), reps, note,
                  16 * m + 8 * args[1].numel(), 0, err=err)


def pair_records_work(args):
    """Bytes and operations of kernel F's sharded form on these inputs
    (ks, perm, gathered, counts, succ_g, ovl_g, a_s, a_p, gid_lo, gid_hi, i,
    L): keys and positions read once, and the counts; a pair reads its
    partner's position and two 16-byte payloads, and clears the partner's
    a_p where the rank owns it; a link writes succ and ovl, and a_s where
    the rank owns the suffix."""
    from pgrc_tpu_torch.kernels import sweep_pair_claim as kp
    from pgrc_tpu_torch.kernels.sweep import GID_SHIFT, MASK31, payload_words

    ks, perm, gathered, counts, lo, hi = args[:4] + args[8:10]
    ranks = gathered.shape[0]
    sp, pp = kp.pairs_plain(ks, perm >= counts[:, 1].sum())
    flat = gathered.view(ranks, -1)

    def payload(at):
        r, d = kp.gathered_rows(counts, perm[at])
        w = payload_words(d)
        return flat[r, w], flat[r, w + 1]

    (rs, cs), (rp, cp) = payload(sp), payload(pp)
    gid_s, gid_p = (rs >> GID_SHIFT) & MASK31, (rp >> GID_SHIFT) & MASK31
    ok = (gid_p != gid_s) & (cp == cs)
    own = lambda g: (g >= lo) & (g < hi)
    m = ks.numel()
    return (16 * m + 8 * counts.numel() + 40 * sp.numel() + int(own(gid_p).sum())
            + 8 * int(ok.sum()) + int((ok & own(gid_s)).sum())), OPS_SCAN * m


def check_pair_records(args, note, reps, timed=True):
    """Kernel F's sharded form against its plain version on one rank's round
    (ks, perm, gathered, counts, succ_g, ovl_g, a_s, a_p, gid_lo, gid_hi, i,
    L): every one of CHECK_LAUNCHES launches, each on its own copies of the
    four arrays it updates in place, bit-equal."""
    from pgrc_tpu_torch.kernels import sweep_pair_claim as kp

    head, outs, tail = args[:4], args[4:8], args[8:]

    def on_copies(fn):
        def run():
            mine = tuple(t.clone() for t in outs)
            fn(*head, *mine, *tail)
            return mine
        return run

    want = on_copies(kp.sweep_pair_records_plain)()
    err = max(max_abs_err(on_copies(kp.sweep_pair_records)(), want)
              for _ in range(CHECK_LAUNCHES))
    require(err == 0, f"sweep_pair_claim.sharded {note}: kernel differs from its plain version")
    if not timed:
        return err
    mine = tuple(t.clone() for t in outs)
    ks, perm, _, counts = head
    return record("sweep_pair_claim.sharded", lambda: kp.sweep_pair_records(*head, *mine, *tail),
                  lambda: kp.sweep_pair_records_plain(*head, *mine, *tail), reps, note,
                  *pair_records_work(args), library=cummaxes(ks, perm >= counts[:, 1].sum()),
                  err=err)


def sharded_rounds(dev, label, codes, a_s, a_p, ranks, rounds) -> None:
    """Rounds 1..rounds of a sweep table over `ranks` simulated shards on
    the card, as greedy_scs._round_sharded runs them (each shard a
    contiguous block of rows with its own flags, its own replica of the
    links and its own send buffer, sized from the largest shard; the gather:
    every shard's buffer head, as many chunks as the largest count needs;
    the key layout, its stable sort, F through the permutation): kernel D's
    and F's sharded forms and the key layout held to their plain versions
    on every shard's inputs in every round, each over CHECK_LAUNCHES
    launches on copies, before the kernels advance the state; every
    replica's links equal after each round. -> the rounds in which a
    shard's whole send buffer was gathered."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.core import packed
    from pgrc_tpu_torch.kernels import sweep, sweep_init
    from pgrc_tpu_torch.kernels import sweep_pair_claim as kp

    n, L_ = codes.shape
    lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes), dev)
    h0, h0b = sweep_init.sweep_full_hashes_plain(lanes, nmask, L_)
    base, extra = divmod(n, ranks)
    sizes = [base + (r < extra) for r in range(ranks)]
    shards, lo, whole = [], 0, 0
    for r in range(ranks):
        hi = lo + sizes[r]
        on = lambda a: torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)
        shards.append(dict(
            gids=(lo, hi), lanes=packed.cols_copy(lanes[:, lo:hi]),
            nmask=None if nmask is None else packed.cols_copy(nmask[:, lo:hi]),
            ids=torch.arange(lo, hi, dtype=torch.int32, device=dev),
            h=h0[lo:hi].clone(), p=h0[lo:hi].clone(), h2=h0b[lo:hi].clone(),
            p2=h0b[lo:hi].clone(), a_s=on(a_s), a_p=on(a_p),
            succ=torch.full((n,), -1, dtype=torch.int32, device=dev),
            ovl=torch.zeros((n,), dtype=torch.int32, device=dev),
            bufs=sweep.record_buffers(max(sizes), dev)))
        lo = hi
    for i in range(1, rounds + 1):
        counts = []
        for s in shards:
            args = (s["lanes"], s["nmask"], s["a_s"], s["a_p"], i, L_, s["h"], s["p"],
                    s["h2"], s["p2"], s["ids"], *s["bufs"])
            check_roll_records(args, f"{label}, round {i}, shard {s['gids']}", 0, timed=False)
            counts.append(sweep.sweep_roll_records(*args).tolist())
        m, n_pref = (sum(c[k] for c in counts) for k in (0, 1))
        if n_pref in (0, m):
            continue
        chunks = sweep.record_chunks(max(c[0] for c in counts))
        whole += chunks == shards[0]["bufs"][0].shape[0]
        gathered = torch.stack([s["bufs"][0][:chunks] for s in shards])
        counts = torch.tensor(counts, dtype=torch.int64, device=dev)
        check_keys((gathered, counts, m), f"{label}, round {i}", 0, timed=False)
        ks, perm = torch.sort(kp.sharded_keys(gathered, counts, m), stable=True)
        for s in shards:
            args = (ks, perm, gathered, counts, s["succ"], s["ovl"], s["a_s"], s["a_p"],
                    *s["gids"], i, L_)
            check_pair_records(args, f"{label}, round {i}, shard {s['gids']}", 0, timed=False)
            kp.sweep_pair_records(*args)
        for s in shards[1:]:
            require(torch.equal(s["succ"], shards[0]["succ"])
                    and torch.equal(s["ovl"], shards[0]["ovl"]),
                    f"{label}, round {i}: the shards' link replicas differ")
    links = int((shards[0]["succ"] >= 0).sum())
    say(f"[kernel] sweep_roll_entries.sharded, sweep_pair_claim.keys, sweep_pair_claim.sharded "
        f"{label}: n={n} over {ranks} shards {[s['gids'] for s in shards]}, {rounds} rounds "
        f"bit-equal, {links} links, a shard's whole send buffer gathered in {whole} rounds")
    require(links > 0, f"{label}: no link formed")
    return whole


def sharded_edge_cases(dev) -> int:
    """Kernels D's and F's sharded forms and the key layout on the shapes a
    sharded round gets wrong: a rank with no rows (n < ranks), n not
    divisible by the ranks, a run of equal hashes across ranks, every entry
    on one rank, a rank with active suffixes and no active prefix, one with
    active prefixes and no active suffix, send buffers filled to their last
    word (the largest count exactly the buffer: the gather sends it whole),
    and one run over every entry of 80 scan tiles (past one 32-tile
    look-back window). -> the number of cases."""
    from pgrc_tpu_torch import kernels
    from pgrc_tpu_torch.kernels import sweep

    rng = np.random.default_rng(31)
    genome = rng.integers(0, 4, size=2000, dtype=np.uint8)
    L_ = 40
    ones = lambda n: np.ones(n, dtype=bool)
    sharded_rounds(dev, "a rank with no rows", np.stack([genome[s:s + L_] for s in (20, 0, 10)]),
                   ones(3), ones(3), 4, L_ - 1)
    st = rng.integers(0, genome.size - L_, size=1001)
    codes = genome[st[:, None] + np.arange(L_)]
    sharded_rounds(dev, "n not divisible by the ranks", codes, ones(1001), ones(1001), 4, L_ - 1)
    no_pref, no_suf = ones(1001), ones(1001)
    no_pref[251:501] = False    # rank 1's rows: suffixes only
    no_suf[501:751] = False     # rank 2's rows: prefixes only
    sharded_rounds(dev, "a rank with no active prefix", codes, ones(1001), no_pref, 4, L_ - 1)
    sharded_rounds(dev, "a rank with no active suffix", codes, no_suf, ones(1001), 4, L_ - 1)
    base = np.stack([genome[s:s + L_] for s in range(6)])
    sharded_rounds(dev, "an equal-hash run across ranks",
                   base[rng.permutation(np.repeat(np.arange(6), 40))], ones(240), ones(240), 4,
                   L_ - 1)
    st = rng.integers(0, 200, size=400)
    act = np.zeros(400, dtype=bool)
    act[200:300] = True
    sharded_rounds(dev, "every entry on one rank", genome[st[:, None] + np.arange(L_)], act,
                   act.copy(), 4, L_ - 1)
    # 4 ranks of 4 chunks' rows, all active: round 1 fills every buffer
    n = 2 * sweep.CHUNK * 4
    st = rng.integers(0, genome.size - L_, size=n)
    whole = sharded_rounds(dev, "send buffers filled to their last word",
                           genome[st[:, None] + np.arange(L_)], ones(n), ones(n), 4, L_ - 1)
    require(whole > 0, "no round gathered a whole send buffer")
    # rows all A: every suffix equals every prefix, one run of all entries;
    # suffixes of the even rows, prefixes of the odd rows, so pairs link
    n = 40 * kernels.scan_tile()
    even = np.arange(n) % 2 == 0
    sharded_rounds(dev, "one run over all entries (80 tiles)", np.zeros((n, L_), np.uint8),
                   even, ~even, 3, 2)
    return 8


class _Stop(Exception):
    """Ends a simulated round at a collective whose result is not known yet."""


class SimMesh:
    """Rank `rank` of `size` shards simulated on one card, as the mesh a
    tree's greedy_scs._round_sharded is given: its collectives hand back
    what every shard sent (`counts` [size, (m, prefixes)], `sent` the
    gathered buffer), moving nothing, after the send side's own device work
    (this tree's all_gather_rows sends its buffer's head as it is; the
    parent tree's all_gather_parts copied its rows into a padded buffer
    first). Without `counts`, or `sent`, the round stops at that collective
    and keeps what this rank sends there (`send`)."""

    def __init__(self, rank, size, device, counts=None, sent=None):
        from pgrc_tpu_torch.kernels import sweep

        self.rank, self.size, self.device = rank, size, device
        self.counts, self.sent, self.send = counts, sent, None
        # this tree's count gather also hands back the counts on the card;
        # the parent tree's gave the host array alone
        self.on_card = (None if counts is None or not hasattr(sweep, "CHUNK")
                        else torch.from_numpy(counts).to(device))

    def gather_counts(self, t):
        if self.counts is None:
            self.send = t.tolist()
            raise _Stop
        return self.counts if self.on_card is None else (self.counts, self.on_card)

    def _gathered(self, send):
        if self.sent is None:
            self.send = send.clone()
            raise _Stop
        return self.sent

    def all_gather_rows(self, t, rows):
        send = t[:rows]
        if send.shape[0] < rows:
            send = torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device=t.device)
            send[:t.shape[0]].copy_(t)
        return self._gathered(send)

    def all_gather_parts(self, t, counts):
        counts = [int(c) for c in counts]
        pad = torch.empty((max(counts), *t.shape[1:]), dtype=t.dtype, device=t.device)
        pad[:counts[self.rank]].copy_(t[:counts[self.rank]])
        return [buf[:c] for buf, c in zip(self._gathered(pad).unbind(0), counts)]


def round_state(codes, dev) -> dict:
    """A sweep table's state before its first round: the init (G, the
    sort, G2) of `codes` on the card."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.core import packed
    from pgrc_tpu_torch.overlap import greedy_scs as g

    lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes), dev)
    h0, h0b, _, _, a_s, a_p = g._init_links(lanes, nmask, codes.shape[1])
    return dict(lanes=lanes, nmask=nmask, h=h0, p=h0.clone(), h2=h0b, p2=h0b.clone(),
                a_s=a_s, a_p=a_p)


class SimRound:
    """Round i of a sweep table cut into `ranks` simulated shards on one
    card, run by the greedy_scs._round_sharded of the tree on the path (so
    that ab.py runs a parent tree's round the same way): `state` the whole
    table before the round (lanes, nmask, h, p, h2, p2, a_s, a_p, on the
    card). Building it runs every shard's round twice up to a collective,
    for the counts and for what each shard sends."""

    def __init__(self, state, ranks, i, L_):
        self.state, self.ranks, self.i, self.L = state, ranks, i, L_
        self.dev = state["h"].device
        base, extra = divmod(state["h"].numel(), ranks)
        self.sizes = [base + (r < extra) for r in range(ranks)]
        self.counts = self.sent = None
        counts = np.array([self.run(r)[2].send for r in range(ranks)], dtype=np.int64)
        self.counts = counts
        sends = [self.run(r)[2].send for r in range(ranks)]
        self.sent = None if sends[0] is None else torch.stack(sends)
        self.m = int(counts[:, 0].sum())

    def table(self, r) -> dict:
        """Rank r's table, as the tree's find_overlaps builds it."""
        from pgrc_tpu_torch.kernels import sweep
        from pgrc_tpu_torch.overlap import greedy_scs as g

        lo = sum(self.sizes[:r])
        hi = lo + self.sizes[r]
        st = self.state
        t = {k: g._block(st[k], lo, hi) for k in ("lanes", "h", "p", "h2", "p2", "a_s", "a_p")}
        t["nmask"] = None if st["nmask"] is None else g._block(st["nmask"], lo, hi)
        # this tree sizes every rank's send buffer from the largest shard,
        # the parent tree from the rank's own rows
        rows = max(self.sizes) if hasattr(sweep, "CHUNK") else hi - lo
        t.update(ids=torch.arange(lo, hi, dtype=torch.int32, device=self.dev), gids=(lo, hi),
                 entries=g._entry_buffers(rows, self.dev, self))
        return t

    def links(self):
        n = self.state["h"].numel()
        return (torch.full((n,), -1, dtype=torch.int32, device=self.dev),
                torch.zeros((n,), dtype=torch.int32, device=self.dev))

    def run(self, r):
        """Rank r's round on a fresh table -> (table, (succ, ovl), mesh)."""
        from pgrc_tpu_torch.overlap import greedy_scs as g

        t, links = self.table(r), self.links()
        mesh = SimMesh(r, self.ranks, self.dev, self.counts, self.sent)
        try:
            g._round_sharded(self.i, self.L, t, *links, mesh)
        except _Stop:
            pass
        return t, links, mesh

    def check(self) -> int:
        """Every shard's round against the one-device round on the whole
        table: every replica's links, and all shards' flags in shard order.
        -> the links the round made."""
        from pgrc_tpu_torch.kernels import sweep
        from pgrc_tpu_torch.overlap import greedy_scs as g

        n = self.state["h"].numel()
        one = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
               for k, v in self.state.items()}
        one.update(ids=torch.arange(n, dtype=torch.int32, device=self.dev),
                   entries=sweep.round_buffers(n, self.dev))
        succ, ovl = self.links()
        g._round(self.i, self.L, one, succ, ovl)
        runs = [self.run(r) for r in range(self.ranks)]
        require(all(torch.equal(s, succ) and torch.equal(o, ovl) for _, (s, o), _ in runs)
                and all(torch.equal(torch.cat([t[k] for t, _, _ in runs]), one[k])
                        for k in ("a_s", "a_p")),
                "the simulated shards' round differs from the one-device round")
        return int((succ >= 0).sum())

    def rank0(self):
        """Rank 0's round, repeatable: -> (round, restore), the round first
        restoring the two flag arrays F clears (the restore alone)."""
        from pgrc_tpu_torch.overlap import greedy_scs as g

        t, (succ, ovl) = self.table(0), self.links()
        mesh = SimMesh(0, self.ranks, self.dev, self.counts, self.sent)
        a_s, a_p = t["a_s"].clone(), t["a_p"].clone()
        restore = lambda: (t["a_s"].copy_(a_s), t["a_p"].copy_(a_p))

        def round_():
            restore()
            g._round_sharded(self.i, self.L, t, succ, ovl, mesh)
        return round_, restore

    def span_ms(self, reps) -> tuple:
        """Device ms of rank 0's round from D's launch to F's end, without
        the collectives (`rank0`), timed twice, of its two flag restores
        alone, and the host ms a round takes to queue (the round's Python
        and launches, timed on the host's clock while the card spins)."""
        round_, restore = self.rank0()
        span = [cuda_ms(round_, reps, spin=ROUND_QUEUE_CYCLES) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda._sleep(ROUND_QUEUE_CYCLES)
        t0 = time.perf_counter()
        for _ in range(reps):
            round_()
        host = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        return span, cuda_ms(restore, reps), host

    def breakdown(self, reps) -> tuple:
        """Rank 0's round under torch.profiler (CUDA activity), `reps`
        times after one warm-up: -> (device ms a round, [(kernel or copy
        name cut to 60 characters, ms a round, launches a round)] by time)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        round_, _ = self.rank0()
        round_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                round_()
            torch.cuda.synchronize()
        rows = [(e.key[:60], (getattr(e, "self_device_time_total", 0) or getattr(
            e, "self_cuda_time_total", 0)) / 1e3 / reps, e.count / reps)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        return sum(r[1] for r in rows), rows


def sharded_round_phase(label, state, i, L_, ranks) -> dict:
    """Round i of `state` over `ranks` simulated shards (SimRound): every
    shard's round equal to the one-device round; on every shard kernel D's
    and F's sharded forms, and the key layout, held to their plain versions
    over CHECK_LAUNCHES launches on the inputs the round gave them, rank
    0's timed beside their bounds; rank 0's round from D to F timed. ->
    rank 0's kernels' JSON fields, by name."""
    from pgrc_tpu_torch.kernels import sweep
    from pgrc_tpu_torch.overlap import greedy_scs as g

    t0 = time.time()
    sim = SimRound(state, ranks, i, L_)
    require(sim.sent is not None, f"{label}: no pair can form over the shards")
    links = sim.check()
    out = {}
    for r in range(ranks):
        with FirstCall(g, "sweep_roll_records") as d, FirstCall(g, "sweep_pair_records") as f:
            sim.run(r)
        reps = 20 if r == 0 else 0
        note = (f"{label} over {ranks} simulated shards, shard {r}: n={sim.sizes[r]} rows, "
                f"m={sim.m} gathered entries")
        got = check_roll_records(d.args, note, reps, timed=r == 0)
        if r == 0:
            out["sweep_roll_entries.sharded"] = got
            out["sweep_pair_claim.keys"] = check_keys(f.args[2:4] + (sim.m,), note, reps)
        got = check_pair_records(f.args, note, reps, timed=r == 0)
        if r == 0:
            out["sweep_pair_claim.sharded"] = got
        d.args = f.args = None
    span, restore, host = sim.span_ms(20)
    busy, rows = sim.breakdown(10)
    big = int(sim.counts[:, 0].max())
    sent = sweep.record_chunks(big) * sweep.CHUNK_WORDS * 8
    say(f"[round] {label} over {ranks} simulated shards: counts (m, prefixes) "
        f"{sim.counts.tolist()}, a rank's gather sends {sent} B (24 B an entry of the largest "
        f"count, {big}, in whole chunks); every shard's round equal to the one-device round "
        f"({links} links); rank 0's round from D's launch to F's end, no collective, timed "
        f"twice: {span[0]:.4f} and {span[1]:.4f} ms device time, of which the two flag "
        f"restores of each timed call take {restore:.4f} ms alone; the host queues a round in "
        f"{host:.4f} ms; under torch.profiler {busy:.4f} ms of kernels and copies a round: "
        + "; ".join(f"{n} {ms:.4f} ms x{c:g}" for n, ms, c in rows)
        + f" ({time.time() - t0:.1f} s)")
    return out


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version on the card, at the main path's
    shapes (E, F, G, G2, D, H and I at theirs in phases 5-7), and every
    kernel on its edge cases; returns {name: JSON fields}."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.align.matcher import probe_offsets
    from pgrc_tpu_torch.core import packed
    from pgrc_tpu_torch.kernels import kmer_hash

    rng = np.random.default_rng(123)
    out = {}

    # A: verify_best, R = 2^18 rows, S = 23 slots, reads sampled from the
    # pg, anchors 70% in range (half of them within 2 of the read's start);
    # its main-path row comes from SE 2M's encode (phase 5)
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
    res = torch.from_numpy(anchors(rng, R, offs, pg_len, L, 0.7, true_st)).to(dev)
    rows = {}
    for nv in (6, 1):
        rows[nv] = check_verify((lanes, res, offs, pg_lanes, pg_len, L, 33, nv, False),
                                f"R={R} S={S} n_verify={nv}", 20)
    out["verify_best"] = rows[6]
    del res

    # B: index_kmer_hash over the 5M-symbol pg, k = 32, k1 = 4: join keys
    # (8 B) and int32 positions written, the pg's lanes read once
    m = (pg_lanes.numel() - 1) * 16 // 4
    args = (pg_lanes, 32, 4, pg_len, m)
    out["index_kmer_hash"] = record(
        "index_kmer_hash", lambda: kmer_hash.index_kmer_hash(*args), lambda: kmer_hash.index_kmer_hash_plain(*args), 20,
        f"m={m} k=32 k1=4", pg_lanes.numel() * 4 + m * 12, hash_ops(m * 4 + 32, m))

    # C: probe_kmer_hash, R = 2^18 rows, S = 23 offsets: the lanes read
    # once, one 8-byte join key written per probe
    out["probe_kmer_hash"] = record(
        "probe_kmer_hash", lambda: (kmer_hash.probe_kmer_hash(lanes, offs, 32),), lambda: (kmer_hash.probe_kmer_hash_plain(lanes, offs, 32),),
        20, f"R={R} S={S} k=32", lanes.numel() * 4 + S * 4 + R * S * 8,
        hash_ops(R * (max(offs) + 32), R * S))

    # G, G2, D and H on sweep tables of n = 2^18 rows (D and H without and
    # with N; G in its init and hash-only forms); their main-path rows come
    # from SE 2M's encode (phase 5)
    n = 1 << 18
    for with_n in (False, True):
        table = sweep_table(dev, n, rng, 0.8, n_frac=0.05 if with_n else 0.0)
        lanes_d, nmask_d = table[:2]
        if with_n:
            for with_key in (True, False):
                check_hashes((lanes_d, nmask_d, L, with_key), f"n={n} N={with_n} key={with_key}",
                             20)
            check_links(links_args(lanes_d, nmask_d), f"n={n}", 20)
        check_roll(roll_args(table, 1), f"n={n} round 1 N={with_n}, 0.8 active", 20)
        half = list(table)
        half[7], half[8] = (torch.from_numpy(rng.random(n) < 0.35).to(dev) for _ in range(2))
        check_compact(tuple(half), f"n={n} N={with_n}, {int((half[7] | half[8]).sum())} kept",
                      20)
        del table, half
    # J at SE 2M's full sweep: 1.76M reads of L 100 at 40x, N in 5% of the
    # rows, 2% of the links shortened and 2% to random reads; its main-path
    # row comes from SE 2M's encode (phase 5)
    args = links_table(dev, 1_760_000, rng)
    check_verify_links(args, f"n={args[3].numel()} L {L} at 40x, N in 5% of the rows", 20)
    del args

    phase_kernels_l150(dev)

    # B and C at the edges of their tiles and lanes; E, F, D and H on their
    # scan edge cases, G and G2 on theirs (E's and F's main-path shapes come
    # in phases 5, 6)
    t0 = time.time()
    cases = verify_edge_cases(dev)
    say(f"[kernel] verify_best: {cases} edge cases bit-equal in {time.time() - t0:.1f} s")
    t0 = time.time()
    cases = strand_edge_cases(dev)
    say(f"[kernel] strand_rows: {cases} edge cases bit-equal in {time.time() - t0:.1f} s")
    t0 = time.time()
    cases = sweep_edge_cases(dev)
    say(f"[kernel] sweep_full_hashes, sweep_init_links, sweep_roll_entries, sweep_compact, "
        f"sweep_verify_links: "
        f"{cases} edge cases bit-equal in {time.time() - t0:.1f} s")
    t0 = time.time()
    cases = hash_edge_cases(dev)
    say(f"[kernel] index_kmer_hash, probe_kmer_hash: {cases} edge cases bit-equal in {time.time() - t0:.1f} s")
    t0 = time.time()
    cases = scan_edge_cases(dev)
    say(f"[kernel] join_carry, sweep_pair_claim: {cases} edge cases bit-equal in "
        f"{time.time() - t0:.1f} s")
    t0 = time.time()
    cases = sharded_edge_cases(dev)
    say(f"[kernel] sweep_roll_entries.sharded, sweep_pair_claim.keys, sweep_pair_claim.sharded: "
        f"{cases} edge cases bit-equal in {time.time() - t0:.1f} s")
    return out


def phase_kernels_l150(dev) -> None:
    """Kernels A, G, G2, D, H, I and J at L 150 (W 10 lanes a
    row; A verifies in batches of 4 from W 9), at the shapes of an SE 2M
    encode's first probe, init, round, compaction, link check and strand
    prep (the 2x150 bp cell encodes 2M reads): each against its plain
    version on the card, bit-equal, and timed beside its bound."""
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.core import packed

    rng = np.random.default_rng(150)
    # A: SE 2M's first probe, R 1,690,146 reads, 18.3% of the slots in
    # range, on a 10M-symbol pg; max_mis L // 3
    pg_len, R = 10_000_000, 1_690_146
    offs = probe_offsets_l(L150)
    pg = rng.integers(0, 4, size=pg_len, dtype=np.uint8)
    pg_lanes = state.pg_lanes_to_device(pg, dev)
    true_st = rng.integers(0, pg_len - L150 + 1, size=R)
    reads = pg[true_st[:, None] + np.arange(L150)[None, :]]
    err_mask = rng.random(reads.shape) < 0.02
    reads[err_mask] = (reads[err_mask] + 1) % 4
    lanes, _ = state.lanes_to_device(*packed.pack_lanes(reads), dev)
    res = torch.from_numpy(anchors(rng, R, offs, pg_len, L150, 0.183, true_st)).to(dev)
    check_verify((lanes, res, offs, pg_lanes, pg_len, L150, L150 // 3, 6, False),
                 f"L {L150}: R={R} S={len(offs)} n_verify=6", 20)
    del res, lanes, pg_lanes, reads, err_mask
    # I: SE 2M's strand prep, 845,073 reads, no N mask
    codes = rng.integers(0, 4, size=(845_073, L150), dtype=np.uint8)
    lanes, _ = state.lanes_to_device(*packed.pack_lanes(codes), dev)
    check_strand((lanes, None, L150, None), f"L {L150}: {codes.shape[0]} reads, no N", 20)
    del lanes, codes
    # G, G2, D and H: SE 2M's first table, n 1.76M rows without N; D's
    # round 1 with 0.96 of the entries active (3.39M of 3.52M), H keeping
    # 0.81 of the rows (1.42M of 1.76M)
    n = 1_760_000
    table = sweep_table(dev, n, rng, 0.96, n_frac=0.0, read_len=L150)
    check_hashes((table[0], None, L150, True), f"L {L150}: n={n} key=True", 20)
    check_links(links_args(table[0], None, L150), f"L {L150}: n={n}", 20)
    check_roll(roll_args(table, 1, L150), f"L {L150}: n={n} round 1, 0.96 active", 20)
    half = list(table)
    half[7], half[8] = (torch.from_numpy(rng.random(n) < 0.56).to(dev) for _ in range(2))
    check_compact(tuple(half), f"L {L150}: n={n}, {int((half[7] | half[8]).sum())} kept", 20)
    del table, half
    # J: the links of that table's full sweep at 30x (a read every 5 bases
    # of L 150), no N
    args = links_table(dev, n, rng, L150, step=5.0, n_frac=0.0)
    check_verify_links(args, f"L {L150}: n={n} at 30x, no N", 20)
    del args


class FirstCall:
    """Spy on a kernel wrapper of the main path: calls through, and keeps
    copies of the inputs of its first call (before a call that writes in
    place), or of the first for which `when(args)` holds. Tensor arguments
    at the indices in `hold` are kept as they are (ones the run never
    writes and keeps alive anyway), those in `host` copied to the host (so
    the copy adds nothing to the run's peak device memory), the others
    cloned on the card. The wrapper counts its own launches, so the spy
    changes none."""

    def __init__(self, module, name, hold=(), host=(), when=lambda args: True):
        self.module, self.name, self.hold, self.host = module, name, hold, host
        self.when, self.real, self.args = when, getattr(module, name), None

    def __enter__(self):
        def copy(i, a):
            if not isinstance(a, torch.Tensor) or i in self.hold:
                return a
            return a.cpu() if i in self.host else a.clone()

        def spy(*args, **kwargs):
            if self.args is None and self.when(args):
                self.args = tuple(copy(i, a) for i, a in enumerate(args)) + tuple(kwargs.values())
            return self.real(*args, **kwargs)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)
        return False


# kernel A's first call on the main path: the read lanes and the pg lanes
# kept as they are, the join's anchors copied to the host
VERIFY_SPY = {"hold": (0, 3), "host": (1,)}


def check_verify_call(args, dev, note):
    """Kernel A held against its plain version on the inputs of a captured
    main-path call (FirstCall with VERIFY_SPY), and timed there."""
    lanes, res, offs, pg_lanes, pg_len, L_, max_mis, n_verify, wide = args
    res = res.to(dev)
    share = float(anchored(res, offs, pg_len, L_).float().mean())
    return check_verify((lanes, res, offs, pg_lanes, pg_len, L_, max_mis, n_verify, wide),
                        f"{note}: R={res.shape[0]} S={res.shape[1]}, pg {pg_len} symbols, "
                        f"n_verify {n_verify}, max_mis {max_mis}, {'int64' if wide else 'int32'}, "
                        f"{share:.3f} of the slots in range", 20)


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


class JoinOps:
    """Spy on matcher.join_sort: the aten ops its calls dispatch (a
    TorchDispatchMode around each call) and the number of calls."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        from pgrc_tpu_torch.align import matcher

        ops = self.ops = set()
        self.calls = 0
        self.real = real = matcher.join_sort

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.add(str(func.overloadpacket))
                return func(*args, **(kwargs or {}))

        def spy(*args):
            self.calls += 1
            with Log():
                return real(*args)

        matcher.join_sort = spy
        return self

    def __exit__(self, *exc):
        from pgrc_tpu_torch.align import matcher

        matcher.join_sort = self.real
        return False


class ProbeGap:
    """Spy on matcher.probe: the aten ops its calls dispatch between the
    join's anchors (matcher.join_anchors returning) and kernel A's call
    (matcher.verify_best), and the number of calls. Only views may run
    there: kernel A turns the anchors into starts itself."""

    VIEWS = {"aten.view", "aten._unsafe_view", "aten.alias"}
    NAMES = ("probe", "join_anchors", "verify_best")

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        from pgrc_tpu_torch.align import matcher

        ops = self.ops = set()
        self.calls = 0
        gap = [False]
        real = self.real = {n: getattr(matcher, n) for n in self.NAMES}

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if gap[0]:
                    ops.add(str(func.overloadpacket))
                return func(*args, **(kwargs or {}))

        def probe(*args, **kwargs):
            self.calls += 1
            with Log():
                return real["probe"](*args, **kwargs)

        def join_anchors(*args, **kwargs):
            out = real["join_anchors"](*args, **kwargs)
            gap[0] = True
            return out

        def verify_best(*args, **kwargs):
            gap[0] = False
            return real["verify_best"](*args, **kwargs)

        for name, fn in zip(self.NAMES, (probe, join_anchors, verify_best)):
            setattr(matcher, name, fn)
        return self

    def __exit__(self, *exc):
        from pgrc_tpu_torch.align import matcher

        for name, fn in self.real.items():
            setattr(matcher, name, fn)
        return False


class RoundGap:
    """Spy on a rank's sharded overlap rounds (greedy_scs._round_sharded):
    the aten ops each round dispatches between the records gather
    (mesh.all_gather_rows returning) and kernel F's sharded form
    (greedy_scs.sweep_pair_records), and the number of such gaps. Only
    views, allocations and the library's sort may run there: the key
    layout is a kernel, and nothing copies, permutes or uploads."""

    ALLOWED = {"aten.view", "aten._unsafe_view", "aten.alias", "aten.select", "aten.slice",
               "aten.empty", "aten.sort"}

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        from pgrc_tpu_torch.overlap import greedy_scs as g

        ops = self.ops = set()
        self.gaps = 0
        gap = [False]
        self.real = real = (self.mesh.all_gather_rows, g.sweep_pair_records, g._round_sharded)

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if gap[0]:
                    ops.add(str(func.overloadpacket))
                return func(*args, **(kwargs or {}))

        def gather(*args, **kwargs):
            out = real[0](*args, **kwargs)
            gap[0] = True
            self.gaps += 1
            return out

        def pair(*args, **kwargs):
            gap[0] = False
            return real[1](*args, **kwargs)

        def round_(*args, **kwargs):
            with Log():
                return real[2](*args, **kwargs)

        self.mesh.all_gather_rows = gather
        g.sweep_pair_records, g._round_sharded = pair, round_
        return self

    def __exit__(self, *exc):
        from pgrc_tpu_torch.overlap import greedy_scs as g

        self.mesh.all_gather_rows = self.real[0]
        g.sweep_pair_records, g._round_sharded = self.real[1:]
        del self.real   # the wrapped functions may be other spies, holding their copies
        return False


class StrandOps:
    """Spy on matcher.match_reads: the aten ops each call dispatches outside
    its passes (matcher.probe_rows) and its index (matcher.device_index),
    which are the reads' upload, kernel I's strand rows for pass 1 and its
    row take for pass 2; every op it dispatches anywhere; and kernel I's
    calls in each form. Outside the passes and the index only the upload's
    copies and kernel I's output allocation may run (the wrapper dispatches
    nothing else on the card), and no index_select may run at all."""

    # beside the upload's ops, the profiler markers of the matcher's spans
    # (utils.trace mirrors each span as a record_function under
    # torch.profiler), which run no device work
    ALLOWED = {"aten._to_copy", "aten.copy_", "aten.empty", "aten.lift_fresh", "aten.alias",
               "aten.view", "aten.detach", "profiler._record_function_enter_new",
               "profiler._record_function_exit"}
    NAMES = ("match_reads", "probe_rows", "device_index", "strand_rows")

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        from pgrc_tpu_torch.align import matcher

        self.outside, self.anywhere = set(), set()
        self.calls = self.prep = self.takes = 0
        inner = [0]
        real = self.real = {n: getattr(matcher, n) for n in self.NAMES}
        spy = self

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = str(func.overloadpacket)
                spy.anywhere.add(name)
                if not inner[0]:
                    spy.outside.add(name)
                return func(*args, **(kwargs or {}))

        def match_reads(*args, **kwargs):
            self.calls += 1
            with Log():
                return real["match_reads"](*args, **kwargs)

        def within(name):
            def call(*args, **kwargs):
                inner[0] += 1
                try:
                    return real[name](*args, **kwargs)
                finally:
                    inner[0] -= 1
            return call

        def strand_rows(lanes, nmask, L_, rows=None):
            if rows is None:
                self.prep += 1
            else:
                self.takes += 1
            return real["strand_rows"](lanes, nmask, L_, rows)

        for name, fn in zip(self.NAMES, (match_reads, within("probe_rows"),
                                         within("device_index"), strand_rows)):
            setattr(matcher, name, fn)
        return self

    def __exit__(self, *exc):
        from pgrc_tpu_torch.align import matcher

        for name, fn in self.real.items():
            setattr(matcher, name, fn)
        return False

    def require(self, label, takes):
        """Every match_reads built its rows with kernel I and dispatched
        nothing else outside its passes and index, none an index_select;
        `takes`: whether pass 2 ran (a take each call) or not (none)."""
        extra = sorted(self.outside - self.ALLOWED)
        say(f"[{label}] match_reads: {self.calls} calls, kernel I {self.prep} strand preps and "
            f"{self.takes} pass-2 takes; ops outside the passes and the index: "
            f"{sorted(self.outside)}")
        require(self.calls > 0 and self.prep == self.calls and not extra,
                f"{label}: the strand prep ran {extra} beside kernel I")
        require("aten.index_select" not in self.anywhere,
                f"{label}: match_reads ran index_select")
        require(self.takes == (self.calls if takes else 0),
                f"{label}: {self.takes} pass-2 takes in {self.calls} match_reads calls")


class SweepSpy:
    """Spy on greedy_scs.find_overlaps: records each device sweep table (its
    rows, and whether it ran the init or a repair) — not the numpy mirror
    of small inputs, not the part loop of a partitioned sweep. With
    dispatch=True it also logs, in a TorchDispatchMode around each
    outermost call, the aten ops the sweep dispatches that the card's path
    must not (nonzero, cat, any, masked selects, indexing by a boolean
    mask) and its host syncs (a scalar read or a copy from the card to the
    host)."""

    BANNED = {"aten.nonzero", "aten.nonzero_static", "aten.cat", "aten.any",
              "aten.masked_select", "aten.masked_scatter"}
    INDEXING = {"aten.index", "aten.index_put", "aten.index_put_", "aten._index_put_impl_"}

    def __init__(self, dispatch=False):
        self.dispatch = dispatch
        self.tables, self.banned, self.syncs = [], set(), {}

    def _log(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        spy = self

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = str(func.overloadpacket)
                if name in SweepSpy.BANNED:
                    spy.banned.add(name)
                if name in SweepSpy.INDEXING and any(
                        isinstance(i, torch.Tensor) and i.dtype == torch.bool
                        for i in (args[1] if len(args) > 1 else ()) or ()):
                    spy.banned.add(f"{name} (boolean mask)")
                out = func(*args, **kwargs)
                from_card = any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
                                for a in args)
                to_host = from_card and (name == "aten._local_scalar_dense" or (
                    name in ("aten._to_copy", "aten.copy_") and isinstance(out, torch.Tensor)
                    and out.device.type == "cpu"))
                if to_host:
                    spy.syncs[name] = spy.syncs.get(name, 0) + 1
                return out
        return Log()

    def __enter__(self):
        from pgrc_tpu_torch.overlap import greedy_scs as g
        from pgrc_tpu_torch.parallel.mesh import active

        self.real = real = g.find_overlaps
        depth = [0]

        def spy(codes, coef=1.0, init_active=None, *, device, mesh=None, rows=None):
            n = codes.shape[0] if rows is None else len(rows)
            sharded = active(mesh) is not None
            if (n > g._HOST_SWEEP_MAX or (sharded and n > 1)) and not (
                    n > g._SWEEP_MAX_ROWS and init_active is None):
                # (a rank's rows: the largest table of any rank, init, sharded)
                self.tables.append((max(mesh.splits(n)) if sharded else n,
                                    init_active is None, sharded))
            depth[0] += 1
            try:
                if self.dispatch and depth[0] == 1:
                    with self._log():
                        return real(codes, coef, init_active, device=device, mesh=mesh,
                                    rows=rows)
                return real(codes, coef, init_active, device=device, mesh=mesh, rows=rows)
            finally:
                depth[0] -= 1

        g.find_overlaps = spy
        return self

    def __exit__(self, *exc):
        from pgrc_tpu_torch.overlap import greedy_scs as g

        g.find_overlaps = self.real
        return False

    def expected(self) -> set:
        """The sweep kernels these tables launch: G, D, F and J in every
        device sweep (D's and F's sharded forms and the key layout in a
        sharded one), G2 and its fill in one that ran its init, H in a table
        that compacts."""
        from pgrc_tpu_torch.overlap import greedy_scs as g

        exp = set()
        for rows, init, sharded in self.tables:
            exp |= {"sweep_full_hashes", "sweep_verify_links", *(
                f"{k}.sharded" if sharded else k for k in (
                "sweep_roll_entries", "sweep_pair_claim"))}
            if sharded:
                exp.add("sweep_pair_claim.keys")
            if init:
                exp |= {"sweep_link_defaults", "sweep_init_links"}
            if rows > g._ONE_SEGMENT_MAX_ROWS:
                exp.add("sweep_compact")
        return exp


def require_launched(label, launches, spy, matcher=True):
    """The run's expected kernels (the matcher's, and the sweep's from the
    spy's tables) each launched, and no sweep kernel launched that its
    tables do not call for."""
    exp = spy.expected() | (set(MATCH_KERNELS) if matcher else set())
    idle = sorted(k for k in exp if launches[k] == 0)
    extra = sorted(k for k in SWEEP_KERNELS if launches[k] and k not in exp)
    say(f"[{label}] device sweep tables (rows, init, sharded): {spy.tables}; expected kernels "
        f"{sorted(exp)}")
    require(not idle and not extra, f"{label}: kernels never launched: {idle}; launched "
            f"where no table calls for them: {extra}")


# kernels whose traced device time profiled() prints by name (substrings of
# the kernel names): B and C, the sweep's kernels, the join's and the
# sweep's sorts, the scans' scratch memsets, and what a concatenation or an
# elementwise key pass would launch
TRACED_GROUPS = (("A", "verify_best"), ("B", "index_kmer_hash"), ("C", "probe_kmer_hash"),
                 ("E", "join_carry"), ("I", "strand_rows"),
                 ("G", "sweep_full_hashes"), ("G2 fill", "sweep_link_defaults"),
                 ("G2", "sweep_init_links"),
                 ("D", "sweep_roll_entries"), ("F", "sweep_pair_claim"),
                 ("H", "sweep_compact"), ("J", "sweep_verify_links"), ("sorts", "Sort"),
                 ("memset", "Memset"),
                 ("cat", "CatArray"), ("elementwise", "elementwise_kernel"))


def profiled(fn, label, banned=(), sweep=False):
    """Run fn() under torch.profiler, inside a recorder of the port's spans
    (`utils.trace.record(label)`): print the `[trace]` line of every span it
    and the encodes inside it recorded (the host wall of each), the wall, the
    device time (sum of the kernels' and copies' self time), the busy share,
    the eight largest device items and the TRACED_GROUPS; fail if a kernel
    named in `banned` or an aten::cummax op ran, or if the join's sort
    (matcher.join_sort) dispatched any op but torch.sort and its slice of
    the key buffer, or any op but a view ran between the join's anchors and
    kernel A (ProbeGap), or match_reads built its strand rows with anything
    but kernel I and the reads' upload or ran index_select (StrandOps). With
    `sweep`, also fail if the sweep dispatched an op
    of SweepSpy.BANNED or indexed by a boolean mask, or read the card more
    often than once a round (D's count), once a segment end (H's counts)
    and twice a sweep (its links); print those host syncs. -> fn's
    result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pgrc_tpu_torch import kernels
    from pgrc_tpu_torch.utils import trace

    torch.cuda.synchronize()
    before = dict(kernels.launches)
    t0 = time.time()
    with JoinOps() as join_ops, ProbeGap() as gap, SweepSpy(dispatch=sweep) as sweep_spy, \
            StrandOps() as strand, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            trace.record(label) as rec:
        res = fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    for r in [rec] + [r for r in trace.recent() if r.encode_id > rec.encode_id]:
        for s in r.spans:
            say(trace.line(r, s))
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    self_us = lambda e: getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0)
    busy = sum(self_us(e) for e in dev) / 1e6
    top = sorted(dev, key=self_us, reverse=True)[:8]
    say(f"[{label}] traced: wall {wall:.3f} s, device time {busy:.3f} s, busy share "
        f"{busy / wall:.3f}; largest: " + "; ".join(
            f"{e.key[:60]} {self_us(e) / 1e3:.1f} ms x{e.count}" for e in top))
    groups = []
    for name, pat in TRACED_GROUPS:
        sel = [e for e in dev if pat in e.key]
        groups.append(f"{name} {sum(self_us(e) for e in sel) / 1e3:.3f} ms "
                      f"x{sum(e.count for e in sel)}")
    say(f"[{label}] traced device time: " + "; ".join(groups) + f"; the join's sort: "
        f"{join_ops.calls} calls dispatching {sorted(join_ops.ops)}")
    require(join_ops.calls > 0 and join_ops.ops - {"aten.slice"} == {"aten.sort"},
            f"{label}: the join's sort ran {sorted(join_ops.ops)}, not torch.sort alone")
    between = sorted(gap.ops - ProbeGap.VIEWS)
    say(f"[{label}] {gap.calls} probes; ops dispatched between the join's anchors and kernel "
        f"A: {sorted(gap.ops) or 'none'}")
    require(gap.calls > 0 and not between,
            f"{label}: ops ran between the join and kernel A: {between}")
    strand.require(label, takes=False)
    ran = sorted({e.key for e in events if e.key in banned or "cummax" in e.key})
    require(not ran, f"{label}: the traced run launched cummax: {ran}")
    require(busy > 0, f"{label}: the profiler saw no device time")
    if sweep:
        rounds, ends = (kernels.launches[k] - before[k]
                        for k in ("sweep_roll_entries", "sweep_compact"))
        syncs = sum(sweep_spy.syncs.values())
        allowed = rounds + ends + 2 * len(sweep_spy.tables)
        say(f"[{label}] the sweep: {len(sweep_spy.tables)} device tables "
            f"{sweep_spy.tables}, {rounds} rounds, {ends} compactions; host syncs "
            f"{syncs} {sweep_spy.syncs} (at most one a round, one a compaction and two "
            f"a table: {allowed}); dispatched of the banned ops: "
            f"{sorted(sweep_spy.banned) or 'none'}")
        require(not sweep_spy.banned, f"{label}: the sweep dispatched "
                f"{sorted(sweep_spy.banned)}")
        require(sweep_spy.tables and syncs <= allowed,
                f"{label}: the sweep read the card {syncs} times (at most {allowed})")
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
    beside the input for phase 8; on the others, E, F, G, G2, D and H are
    held against their plain versions on the encode's first join, first
    init, first sweep round and first compaction, I on its strand prep, and
    a second encode runs
    under torch.profiler with the sweep's dispatch spy. -> (launches, src,
    pair, codes)."""
    from contextlib import ExitStack

    from pgrc_tpu_torch import cli, kernels, synth
    from pgrc_tpu_torch.align import matcher
    from pgrc_tpu_torch.archive import decoder
    from pgrc_tpu_torch.overlap import greedy_scs
    from pgrc_tpu_torch.streams import codecs

    dev = torch.device("cuda")
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
    with ExitStack() as stack:
        spy = stack.enter_context(SweepSpy())
        if not first:
            join = stack.enter_context(FirstCall(matcher, "join_carry"))
            probe = stack.enter_context(FirstCall(matcher, "verify_best", **VERIFY_SPY))
            prep = stack.enter_context(FirstCall(matcher, "strand_rows", hold=(0, 1)))
            firsts = {name: stack.enter_context(FirstCall(greedy_scs, name)) for name in (
                "sweep_full_hashes", "sweep_init_links", "sweep_roll_entries",
                "sweep_pair_claim", "sweep_compact")}
            # J's first call: the full sweep's links (its table kept as it is)
            firsts["sweep_verify_links"] = stack.enter_context(
                FirstCall(greedy_scs, "sweep_verify_links", hold=(0, 1)))
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
        f"peak device memory {peak_mb:.0f} MiB{'' if first else ' (with the spy copies)'}, "
        f"stage s {stages}, "
        f"exact multiset round trip {same}, launches {launches}")
    require(same, f"{label}: decoded reads differ from the input")
    validates(label, archive, [src], n_reads)
    require(cpu_same is not False, f"{label}: the card's archive differs from the CPU's")
    require(bits <= gate, f"{label}: {bits:.6f} bits/base exceeds {gate}")
    if codecs._zstd is None:
        require((size, digest) == card_archive, f"{label}: {size} B sha256 {digest}, not "
                f"the port's recorded card archive without zstd ({card_archive})")
    idle = [k for k in MAIN_KERNELS if launches[k] == 0]
    require(not idle, f"{label}: kernels never launched on the main path: {idle}")
    require_launched(label, launches, spy)
    if not first:
        skey, perm, ipos, P = join.args
        timings["join_carry"] = check_join(
            "join_carry", join.args, f"{label}'s first join: m2={skey.numel()} "
            f"({ipos.numel()} index entries, {P} probes)", 20)
        del join.args, skey, perm, ipos
        args = firsts["sweep_pair_claim"].args
        timings["sweep_pair_claim"] = check_pair(
            "sweep_pair_claim", args, f"{label}'s first sweep round: "
            f"m={args[0].numel()} entries of {args[2].numel()} rows", 20)
        timings["verify_best"] = check_verify_call(probe.args, dev, f"{label}'s first probe")
        probe.args = None
        lanes, nmask, L_ = prep.args[:3]   # (pass 1 passes rows=None)
        timings["strand_rows"] = check_strand(
            (lanes, nmask, L_, None), f"{label}'s strand prep: n={lanes.shape[0]} reads, "
            f"L {L_}, N mask {nmask is not None}", 20)
        # the take form at this prep's scale (pass 2 runs only with -l N;
        # its main-path row is phase 7's SE -l 2): a seeded half of the reads
        rows = torch.from_numpy(np.sort(np.random.default_rng(17).choice(
            lanes.shape[0], lanes.shape[0] // 2, replace=False))).to(dev)
        check_strand((lanes, nmask, L_, rows), f"{label}'s reads, a take of half of them: "
                     f"R={rows.numel()}", 20, library=strand_take(lanes, nmask, L_, rows))
        prep.args = None
        del lanes, nmask, rows
        args = firsts["sweep_full_hashes"].args
        timings["sweep_full_hashes"] = check_hashes(
            args, f"{label}'s first init: n={args[0].shape[1]} N={args[1] is not None}", 20)
        t0 = time.time()
        check_init_links(args[0], args[1], args[2], f"{label}'s first init")
        say(f"[kernel] _init_links on the card at {label}'s first init: bit-equal to the "
            f"CPU's over {CHECK_LAUNCHES} runs ({time.time() - t0:.1f} s)")
        args = firsts["sweep_init_links"].args[:4]   # the state it patched is the run's
        timings["sweep_init_links"] = check_links(
            args, f"{label}'s first init: n={args[0].numel()}", 20)
        timings["sweep_link_defaults"] = check_fill(
            args[0].numel(), args[0].device, f"{label}'s first init: n={args[0].numel()}", 20)
        args = firsts["sweep_roll_entries"].args
        timings["sweep_roll_entries"] = check_roll(
            args, f"{label}'s first sweep round: n={args[0].shape[1]} rows, "
            f"{int(args[2].sum()) + int(args[3].sum())} active entries", 20)
        # the same round cut into MESH_RANKS simulated shards: the sharded
        # round's kernels and span at a size where its data outweighs its
        # launches
        lanes, nmask, a_s, a_p, i, L_, h, p, h2, p2 = args[:10]
        sharded_round_phase(f"{label}'s first round", dict(
            lanes=lanes, nmask=nmask, h=h, p=p, h2=h2, p2=p2, a_s=a_s, a_p=a_p), i, L_,
            MESH_RANKS)
        del lanes, nmask, a_s, a_p, h, p, h2, p2
        args = firsts["sweep_compact"].args
        timings["sweep_compact"] = check_compact(
            args, f"{label}'s first compaction: n={args[2].numel()} rows, "
            f"{int((args[7] | args[8]).sum())} kept", 20)
        args = firsts["sweep_verify_links"].args
        timings["sweep_verify_links"] = check_verify_links(
            args, f"{label}'s first sweep's links: n={args[3].numel()} rows, "
            f"N mask {args[1] is not None}", 20)
        for fc in firsts.values():
            fc.args = None
        del args
        free_card()
        torch.cuda.synchronize()
        held_mb = torch.cuda.memory_allocated() / 2**20
        torch.cuda.reset_peak_memory_stats()
        profiled(lambda: cli.main(argv), f"{label} second encode", banned, sweep=True)
        say(f"[{label}] second encode, no spy copies: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB ({held_mb:.0f} MiB "
            f"allocated before it)")
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


def validates(label: str, archive: str, srcs: list, n_reads: int) -> float:
    """The port's validator (`-d -i`, decoder.validate: streamed
    fingerprints, or byte compares in the order-keeping modes) on an
    archive against its source file(s): no error, and every read seen.
    -> seconds."""
    from pgrc_tpu_torch.archive import decoder

    t0 = time.time()
    report = decoder.validate(archive, *srcs)
    val_s = time.time() - t0
    say(f"[{label}] validate against {len(srcs)} file(s): {report} in {val_s:.2f} s")
    require(report["errors"] == 0 and report["reads"] == n_reads,
            f"{label}: the validator reports {report}, not 0 errors in {n_reads} reads")
    return val_s


def decodes_exactly(archive: str, prefix: str, kind: str, inputs: list):
    """Decode with the port's decoder and compare with the input reads:
    in order ("order"), as a multiset of pairs ("pairs"), of unordered pairs
    ("unordered pairs") or of reads ("reads"), read for read; not
    decoder.validate, which compares fingerprints. -> (exact, decode
    seconds)."""
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
    from pgrc_tpu_torch.kernels import kmer_hash

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
    note = (f"{'int64' if wide else 'int32'} block at lane_off {lane_off} (positions "
            f"{lane_off * 16}..{lane_off * 16 + m * 4 - 4}), m={m} k={k} k1=4")
    out["index_kmer_hash.int64" if wide else "index_kmer_hash.block"] = record(
        "index_kmer_hash", lambda: kmer_hash.index_kmer_hash(*args),
        lambda: kmer_hash.index_kmer_hash_plain(*args), 10, note,
        (m // 4 + k // 16 + 2) * 4 + m * (8 + pos_bytes), hash_ops(m * 4 + k, m))
    if wide:
        R, offs = 1 << 18, probe_offsets(L, k, 3)
        S = len(offs)
        true_st = rng.integers(PAST_INT32, pg_len - L + 1, size=R)
        vr = pg[true_st[:, None] + np.arange(L)[None, :]]
        vmask = rng.random(vr.shape) < 0.02
        vr[vmask] = (vr[vmask] + 1) % 4
        lanes, _ = state.lanes_to_device(*packed.pack_lanes(vr), dev)
        res = torch.from_numpy(anchors(rng, R, offs, pg_len, L, 0.7, true_st,
                                       lo=PAST_INT32)).to(dev)
        check_verify((lanes, res, offs, pg_lanes, pg_len, L, max_mis, 6, True),
                     f"int64 R={R} S={S} n_verify=6, starts from {PAST_INT32}", 20)
        del lanes, res
    del pg_lanes
    free_card()
    say(f"[{label}] kernel checks {time.time() - t0:.1f} s")

    index = matcher.build_index(pg, k=k, device_sort=True)
    blocks = -(-(pg_len - k + 1) // (matcher._MAX_INDEX_BLOCK * index.k1))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    run = lambda: matcher.match_reads(reads, index, pg, max_mis, cap=prm.match_cap,
                                      accept_mis=0, device=dev)
    caps, real_cap = [], matcher._batch_cap
    matcher._batch_cap = lambda *a: caps.append(real_cap(*a)) or caps[-1]
    try:
        with FirstCall(matcher, "join_carry") as join, \
                FirstCall(matcher, "verify_best", **VERIFY_SPY) as probe:
            t0 = time.time()
            res = run()
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        matcher._batch_cap = real_cap
    batches = sum(-(-2 * PLANTED // c) for c in caps)   # the pass's row batches
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
        f"{int(exact.sum())} re-verified exactly, index blocks {blocks}, row batches "
        f"{batches}, launches {launches}")
    require(hit.mean() >= 0.99, f"{label}: {hit.mean():.4f} of the reads at their plant")
    miss = np.nonzero(res.pos < 0)[0][:8]
    require(PLANTED - got.size <= 15, f"{label}: {PLANTED - got.size} reads unmatched "
            f"(planted at {st[miss].tolist()}, rc {rc[miss].tolist()})")
    require(exact.all() and (res.mis[got] <= max_mis).all(),
            f"{label}: {int((~exact).sum())} matches fail the host re-verify")
    require(blocks >= (8 if wide else 2) and launches[b_key] == blocks * batches,
            f"{label}: {launches[b_key]} kernel B launches for {blocks} index blocks x "
            f"{batches} row batches")
    other = ("index_kmer_hash", "verify_best", "join_carry") if wide else (
        "index_kmer_hash.int64", "verify_best.int64", "join_carry.int64")
    require(launches[a_key] > 0 and launches["probe_kmer_hash"] > 0
            and launches[e_key] >= blocks and not any(launches[o] for o in other),
            f"{label}: the probe did not run on its {'int64' if wide else 'int32'} kernels")
    require(launches["strand_rows"] == 1 and launches["strand_rows.take"] == 0,
            f"{label}: {launches['strand_rows']} strand preps by kernel I, not one")
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
    fields = check_verify_call(probe.args, dev, f"{label}'s first probe")
    if wide:
        out["verify_best.int64"] = fields
    probe.args = None
    free_card()
    say(f"[{label}] kernel E and A checks {time.time() - t0:.1f} s")
    profiled(run, f"{label} second match_reads", banned)
    free_card()
    return out, launches


def phase_modes(work: str, timings: dict) -> int:
    """Every archive mode on the card against the port's own CPU run; kernel
    I's take form held against its plain version on SE -l 2's pass-2 take.
    -> that run's launches of the take form."""
    from contextlib import ExitStack

    from pgrc_tpu_torch import cli, kernels, synth
    from pgrc_tpu_torch.align import matcher
    from pgrc_tpu_torch.overlap import greedy_scs

    src, pair = (os.path.join(work, f"modes{i}.fastq") for i in (1, 2))
    codes = {"{s}": synth.synth_fastq(src, MODE_READS, L, MODE_GENOME, seed=5, pair=pair),
             "{p}": fastq_codes(pair)}
    parts, take_launches = [], 0
    real_partitioned = greedy_scs._find_overlaps_partitioned

    def partitioned(codes_, coef, *, device, mesh=None, rows=None):
        parts.append(codes_.shape[0] if rows is None else len(rows))
        return real_partitioned(codes_, coef, device=device, mesh=mesh, rows=rows)

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
            two_pass = "-l" in argv
            kernels.reset_launches()
            t0 = time.time()
            with ExitStack() as stack:
                spy = stack.enter_context(SweepSpy())
                strand = stack.enter_context(StrandOps())
                # held, not cloned: a clone would dispatch inside StrandOps's
                # view of the take (the matcher writes none of these)
                take = stack.enter_context(FirstCall(matcher, "strand_rows", hold=(0, 1, 3),
                                                     when=lambda args: len(args) > 3
                                                     and args[3] is not None))
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
        require_launched(f"modes {label}", launches, spy)
        strand.require(f"modes {label}", takes=two_pass)
        require((launches["strand_rows.take"] > 0) == two_pass,
                f"{label}: {launches['strand_rows.take']} launches of kernel I's take form")
        if capped:
            require(parts and launches["index_kmer_hash"] >= 2,
                    f"{label}: no partitioned sweep or no blocked index")
        if two_pass:
            take_launches = launches["strand_rows.take"]
            lanes, nmask, L_, rows = take.args
            timings["strand_rows.take"] = check_strand(
                take.args, f"{label}'s pass-2 take: R={rows.numel()} of {lanes.shape[0]} "
                f"reads, L {L_}, N mask {nmask is not None}", 20,
                library=strand_take(lanes, nmask, L_, rows))
            take.args = None
            del lanes, nmask, rows
    return take_launches


def phase_bench_200k(src: str, pair: str, codes) -> None:
    """bench.py's PE and SE_ORD rows on the card: exact round trips."""
    from pgrc_tpu_torch import cli, kernels

    files = {"{s}": src, "{p}": pair}
    inputs = {"{s}": codes, "{p}": fastq_codes(pair)}
    for label, argv_t, kind, ref_bpb in BENCH_200K:
        argv = [files.get(a, a) for a in argv_t]
        ins = [inputs[a] for a in argv_t if a in inputs]
        archive = os.path.join(os.path.dirname(src), label.replace(" ", "_") + ".pgtc")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.time()
        with SweepSpy() as spy:
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
        validates(label, archive, [files[a] for a in argv_t if a in files],
                  sum(c.shape[0] for c in ins))
        require_launched(label, launches, spy)


def phase_repeat(work: str) -> None:
    """The repeat genome at 200k reads (bench.py's seed 11 and genome
    length), made with `synth`, compressed through the port's CLI on the
    card and on the CPU: the same bytes and an exact decode."""
    from pgrc_tpu_torch import cli, kernels, synth

    label, ref_bpb = BENCH_REPEAT
    n, genome_len, seed = REPEAT_INPUT
    rep_src = os.path.join(work, f"bench_rep_{n}.fastq")
    t0 = time.time()
    codes = synth.synth_fastq(rep_src, n, 100, genome_len, seed=seed, repeats=True)
    say(f"[{label}] input synth {time.time() - t0:.1f} s")
    free_card()
    card, cpu = (os.path.join(work, f"repeat.{d}.pgtc") for d in ("card", "cpu"))
    kernels.reset_launches()
    t0 = time.time()
    with SweepSpy() as spy:
        require(cli.main(["--device", "cuda", "-i", rep_src, card]) == 0,
                f"{label}: compress on the card failed")
        torch.cuda.synchronize()
    card_s = time.time() - t0
    launches = dict(kernels.launches)
    t0 = time.time()
    require(cli.main(["--device", "cpu", "-i", rep_src, cpu]) == 0,
            f"{label}: compress on the CPU failed")
    cpu_s = time.time() - t0
    with open(card, "rb") as a, open(cpu, "rb") as b:
        same = a.read() == b.read()
    exact, dec_s = decodes_exactly(card, os.path.join(work, "repeat.dec"), "reads", [codes])
    size = os.path.getsize(card)
    say(f"[{label}] archive {size} B, {size * 8 / codes.size:.6f} bits/base (pgrc_tpu with "
        f"zstd: {ref_bpb}), card {card_s:.2f} s, CPU {cpu_s:.2f} s, decode {dec_s:.2f} s, "
        f"byte-identical to the CPU's {same}, exact decode {exact}, launches {launches}")
    require(same, f"{label}: the card's archive differs from the CPU's")
    require(exact, f"{label}: the decoded reads differ from the input")
    validates(label, card, [rep_src], n)
    require_launched(label, launches, spy)


class CollectiveClock:
    """Host seconds a rank spends in its mesh's collectives (gloo's copies
    of CUDA tensors through host memory included, and so the wait for the
    device work queued before them, and the wait for the other ranks), by
    wrapping the collectives on the mesh instance."""

    def __init__(self, mesh):
        self.seconds, self.calls = 0.0, 0
        for name in ("gather_counts", "all_gather_rows", "all_reduce"):
            setattr(mesh, name, self._timed(getattr(mesh, name)))

    def _timed(self, fn):
        def call(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.time() - t0
                self.calls += 1
        return call

    def take(self) -> tuple:
        out = (self.seconds, self.calls)
        self.seconds, self.calls = 0.0, 0
        return out


def gloo_cuda_support(mesh) -> dict:
    """Which gloo collectives of the installed torch take CUDA tensors and
    give the right values (the mesh hands gloo its CUDA tensors as they
    are): {collective: "yes", "wrong values" or the error's first line}."""
    import torch.distributed as dist

    t = torch.full((4,), mesh.rank + 1, dtype=torch.int64, device=mesh.device)

    def gather():
        outs = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(outs, t)
        return [int(o[0]) for o in outs] == list(range(1, mesh.size + 1))

    def reduce():
        x = t.clone()
        dist.all_reduce(x)
        return int(x[0]) == mesh.size * (mesh.size + 1) // 2

    def broadcast():
        x = t.clone()
        dist.broadcast(x, 0)
        return int(x[0]) == 1

    out = {}
    for name, call in (("all_gather", gather), ("all_reduce", reduce), ("broadcast", broadcast)):
        try:
            out[name] = "yes" if call() else "wrong values"
        except (RuntimeError, ValueError) as e:
            out[name] = str(e).splitlines()[0][:120]
    return out


def fail_on_rank1(mesh):
    """A rank function that fails on rank 1: `launch` must raise."""
    if mesh.rank == 1:
        raise RuntimeError("a deliberate failure on rank 1")
    return mesh.rank


def mesh_rank(mesh, hq_path: str, src: str, work: str) -> dict:
    """One rank of phase 9, in its own process (parallel.mesh.launch): the
    sweep of SE 200k's HQ reads under SweepSpy's dispatch log, rank 0 saving
    the inputs of the first calls of D's and F's sharded forms; the SE 200k
    encode with its launch counts (set to 0 just before it, read just
    after), timed; the same encode again under torch.profiler for the
    rank's device time. -> what the parent checks and prints."""
    from contextlib import ExitStack

    from pgrc_tpu_torch import kernels
    from pgrc_tpu_torch.archive import encoder
    from pgrc_tpu_torch.config import PgRCParams
    from pgrc_tpu_torch.overlap import greedy_scs

    clock = CollectiveClock(mesh)
    out = {"mesh": mesh.describe()}
    codes = np.load(hq_path)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with ExitStack() as stack:
        spy = stack.enter_context(SweepSpy(dispatch=True))
        firsts = ({name: stack.enter_context(FirstCall(greedy_scs, name))
                   for name in ("sweep_roll_records", "sweep_pair_records")}
                  if mesh.rank == 0 else {})
        # entered after the FirstCall spies, so their copies of F's inputs
        # are made after the gap it watches has closed
        gap = stack.enter_context(RoundGap(mesh))
        t0 = time.time()
        res = greedy_scs.find_overlaps(codes, device=mesh.device, mesh=mesh)
        torch.cuda.synchronize()
        out["sweep_s"] = time.time() - t0
    out.update(succ=res.succ, ovl=res.overlap, sweep_launches=dict(kernels.launches),
               syncs=dict(spy.syncs), banned=sorted(spy.banned), tables=spy.tables,
               sweep_collectives=clock.take(), gap_ops=sorted(gap.ops), gaps=gap.gaps)
    require_launched(f"mesh rank {mesh.rank} sweep", kernels.launches, spy, matcher=False)
    if firsts:
        torch.save({name: tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                                for a in fc.args) for name, fc in firsts.items()},
                   os.path.join(work, "mesh_first_round.pt"))
    del firsts, res
    # the same sweep again: warm, and without the dispatch log
    t0 = time.time()
    greedy_scs.find_overlaps(codes, device=mesh.device, mesh=mesh)
    torch.cuda.synchronize()
    out["warm_sweep_s"], out["warm_sweep_collectives"] = time.time() - t0, clock.take()
    archive = os.path.join(work, f"mesh_rank{mesh.rank}.pgtc")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with SweepSpy() as spy:
        t0 = time.time()
        encoder.encode(PgRCParams(src_fastq=src, output=archive), device=mesh.device, mesh=mesh)
        torch.cuda.synchronize()
        out["encode_s"] = time.time() - t0
    out.update(encode_launches=dict(kernels.launches), archive=archive,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               encode_collectives=clock.take())
    require_launched(f"mesh rank {mesh.rank} encode", kernels.launches, spy)
    out["traced_s"], out["device_s"] = traced_encode(src, archive + ".traced", mesh.device, mesh)
    out["traced_collectives"] = clock.take()
    return out


def traced_encode(src: str, out: str, device, mesh=None) -> tuple:
    """The SE encode of src under torch.profiler (CUDA activity only) ->
    (wall s, device s: the kernels' and copies' self time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pgrc_tpu_torch.archive import encoder
    from pgrc_tpu_torch.config import PgRCParams

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        encoder.encode(PgRCParams(src_fastq=src, output=out), device=device, mesh=mesh)
        torch.cuda.synchronize()
    wall = time.time() - t0
    return wall, sum(getattr(e, "self_device_time_total", 0) or getattr(
        e, "self_cuda_time_total", 0) for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA) / 1e6


def one_device_roll_ms(args) -> float:
    """Kernel D's one-device form timed on the rows of a sharded round's
    inputs (the sharded form's args), its own buffers."""
    from pgrc_tpu_torch.kernels import sweep

    mine = tuple(t.clone() for t in args[6:10])
    bufs = sweep.round_buffers(args[0].shape[1], args[0].device)
    return cuda_ms(lambda: sweep.sweep_roll_entries(*args[:6], *mine, *bufs), 20)


def one_device_pair_ms(args, n: int) -> float:
    """Kernel F's one-device form timed on a sharded round's gathered
    entries (the sharded form's args) recast as one table of n rows: an
    entry is its gid (a prefix) or n + gid (a suffix), in the sorted order,
    the confirm hashes scattered to p2 / h2 by gid."""
    from pgrc_tpu_torch.kernels import sweep_pair_claim as kp
    from pgrc_tpu_torch.kernels.sweep import GID_SHIFT, MASK31, SIDE_BIT, payload_words

    ks, perm, gathered, counts, i, L_ = args[:4] + args[10:12]
    dev = ks.device
    r, d = kp.gathered_rows(counts, perm)
    flat = gathered.view(gathered.shape[0], -1)
    recs, conf = flat[r, payload_words(d)], flat[r, payload_words(d) + 1]
    suf = (recs & SIDE_BIT) != 0
    gid = (recs >> GID_SHIFT) & MASK31
    ent = torch.where(suf, gid + n, gid)
    p2, h2 = (torch.zeros(n, dtype=torch.int64, device=dev) for _ in range(2))
    p2[gid[~suf]] = conf[~suf]
    h2[gid[suf]] = conf[suf]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    outs = (torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev), torch.ones(n, dtype=torch.bool, device=dev))
    return cuda_ms(lambda: kp.sweep_pair_claim(ks, ent, ids, p2, h2, *outs, i, L_), 20)


def phase_mesh(dev, work: str, src: str, timings: dict) -> dict:
    """Phase 9: the sharded path over MESH_RANKS ranks sharing the card
    (gloo): a deliberately failing rank must fail `launch`; SE 200k's HQ
    reads swept on one device and over the ranks (every rank's links the
    one-device links); the SE 200k encode over the ranks (every rank's
    archive the one-device archive of phase 4); D's and F's sharded forms
    held to their plain versions, and timed, on rank 0's first sharded
    round. The kernels were built in phase 2, so the ranks load the library
    and run no nvcc. -> the launches of D's and F's sharded forms in the
    ranks' encodes, summed."""
    from pgrc_tpu_torch.config import PgRCParams
    from pgrc_tpu_torch.core import fastq
    from pgrc_tpu_torch.overlap import greedy_scs
    from pgrc_tpu_torch.parallel import mesh as pmesh

    t0 = time.time()
    try:
        pmesh.launch(fail_on_rank1, 2, device="cpu", timeout_s=300)
        caught = ""
    except pmesh.RankError as e:
        caught = str(e)
    say(f"[mesh] a rank that raises fails launch: {'a deliberate failure' in caught} "
        f"({time.time() - t0:.1f} s)")
    require("a deliberate failure on rank 1" in caught, "a failing rank did not fail launch")
    t0 = time.time()
    support = pmesh.launch(gloo_cuda_support, 2, device="cuda", timeout_s=300)[0]
    say(f"[mesh] gloo with CUDA tensors in torch {torch.__version__}: {support} "
        f"({time.time() - t0:.1f} s)")
    require(support["all_gather"] == support["all_reduce"] == "yes",
            "gloo does not take the mesh's CUDA tensors")
    # SE 200k's HQ reads: the encoder's stage 1 division
    params = PgRCParams(src_fastq=src, output=os.path.join(work, "mesh_unused.pgtc"))
    params.resolve()
    reads = fastq.read_divided(src, None, params.revcomp_pair_file,
                               params.error_limit_promils / 1000.0,
                               params.simplified_suffix_mode)
    hq = reads.codes[~reads.n_mask & reads.hq_mask]
    hq_path = os.path.join(work, "mesh_hq.npy")
    np.save(hq_path, hq)
    torch.cuda.synchronize()
    t0 = time.time()
    one = greedy_scs.find_overlaps(hq, device=dev)
    torch.cuda.synchronize()
    one_s = time.time() - t0
    one_traced = traced_encode(src, os.path.join(work, "mesh_one_traced.pgtc"), dev)
    say(f"[mesh] one device: SE 200k encode under torch.profiler {one_traced[0]:.3f} s, "
        f"device time {one_traced[1]:.4f} s")
    free_card()
    t0 = time.time()
    try:
        outs = pmesh.launch(mesh_rank, MESH_RANKS, hq_path, src, work, device="cuda",
                            timeout_s=900)
    except pmesh.RankError as e:
        raise SmokeFailure(f"mesh: {e}") from None
    say(f"[mesh] {MESH_RANKS} ranks launched and joined in {time.time() - t0:.1f} s")
    with open(os.path.join(work, "se_200000.pgtc"), "rb") as f:
        want = f.read()
    nonzero = lambda d: {k: v for k, v in d.items() if v}
    for r, o in enumerate(outs):
        d_sh = o["sweep_launches"]["sweep_roll_entries.sharded"]
        ends = o["sweep_launches"]["sweep_compact"]
        syncs = sum(o["syncs"].values())
        # a round reads its counts, a segment end H's counts and their max,
        # a table its links (gloo's own copies are no aten op: not seen)
        allowed = d_sh + 2 * ends + 2 * len(o["tables"])
        same = np.array_equal(o["succ"], one.succ) and np.array_equal(o["ovl"], one.overlap)
        say(f"[mesh] rank {r}: {o['mesh']}; sweep of SE 200k's {hq.shape[0]} HQ reads "
            f"{o['sweep_s']:.3f} s, again warm without the dispatch log {o['warm_sweep_s']:.3f} "
            f"s ({o['warm_sweep_collectives'][0]:.3f} s in collectives; one device "
            f"{one_s:.3f} s), tables {o['tables']}, links "
            f"equal to the one device's: {same}; host syncs {syncs} {o['syncs']} (at most "
            f"{allowed}); banned ops {o['banned'] or 'none'}; in collectives "
            f"{o['sweep_collectives'][0]:.3f} s over {o['sweep_collectives'][1]} calls; "
            f"launches {nonzero(o['sweep_launches'])}")
        require(same, f"mesh rank {r}: the sharded sweep's links differ from one device's")
        require(not o["banned"] and syncs <= allowed,
                f"mesh rank {r}: the sweep dispatched {o['banned']} or read the card {syncs} "
                f"times (at most {allowed})")
        f_sh = o["sweep_launches"]["sweep_pair_claim.sharded"]
        extra = sorted(set(o["gap_ops"]) - RoundGap.ALLOWED)
        say(f"[mesh] rank {r}: between the records gather and F's sharded form, {o['gaps']} "
            f"rounds dispatched {o['gap_ops']} (F's sharded form {f_sh} launches, the key "
            f"layout {o['sweep_launches']['sweep_pair_claim.keys']})")
        require(o["gaps"] > 0 and o["gaps"] == f_sh == o["sweep_launches"][
            "sweep_pair_claim.keys"] and not extra, f"mesh rank {r}: {extra} ran between the "
            f"records gather and F's sharded form ({o['gaps']} gaps, {f_sh} F launches)")
        with open(o["archive"], "rb") as f:
            blob = f.read()
        say(f"[mesh] rank {r}: SE 200k encode {o['encode_s']:.3f} s, archive {len(blob)} B "
            f"sha256 {hashlib.sha256(blob).hexdigest()}, equal to the one-device archive "
            f"({len(want)} B): {blob == want}; peak device memory {o['peak_mib']:.0f} MiB; in "
            f"collectives {o['encode_collectives'][0]:.3f} s over "
            f"{o['encode_collectives'][1]} calls; traced encode {o['traced_s']:.3f} s, device "
            f"time {o['device_s']:.4f} s, in collectives {o['traced_collectives'][0]:.3f} s; "
            f"launches {nonzero(o['encode_launches'])}")
        require(blob == want, f"mesh rank {r}: the archive differs from the one-device archive")
    first = torch.load(os.path.join(work, "mesh_first_round.pt"))
    on = lambda args: tuple(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args)
    args = on(first["sweep_roll_records"])
    timings["sweep_roll_entries.sharded"] = check_roll_records(
        args, f"SE 200k's first sharded round on rank 0 of {MESH_RANKS}: n={args[0].shape[1]} "
        f"rows, {int(args[2].sum()) + int(args[3].sum())} active entries", 20)
    say(f"[kernel] sweep_roll_entries (the one-device form) on the same rows: "
        f"{one_device_roll_ms(args):.4f} ms")
    args = on(first["sweep_pair_records"])
    note = (f"SE 200k's first sharded round on rank 0 of {MESH_RANKS}: m={args[0].numel()} "
            f"gathered entries, rank 0's {args[6].numel()} rows")
    timings["sweep_pair_claim.keys"] = check_keys((args[2], args[3], args[0].numel()), note, 20)
    timings["sweep_pair_claim.sharded"] = check_pair_records(args, note, 20)
    say(f"[kernel] sweep_pair_claim (the one-device form) on the same entries as one table "
        f"of {hq.shape[0]} rows: {one_device_pair_ms(args, hq.shape[0]):.4f} ms")
    del first, args
    # the same round over simulated shards on this process's card: the
    # kernels on every shard and the round's span, as SE 2M's in phase 5
    sharded_round_phase("SE 200k's first round of its HQ reads", round_state(hq, dev), 1, L,
                        MESH_RANKS)
    return {name: sum(o["encode_launches"][name] for o in outs)
            for name in ("sweep_roll_entries.sharded", "sweep_pair_claim.sharded",
                         "sweep_pair_claim.keys")}


def phase_entry() -> None:
    """The port's graft entry (__graft_entry_torch__.py) on the card: its
    probe's (mis, pos) equal to its own CPU run's, and most reads matched."""
    import __graft_entry_torch__ as ge

    t0 = time.time()
    fn, args = ge.entry(device="cuda")
    mis, pos = (o.cpu() for o in fn(*args))
    fn, args = ge.entry(device="cpu")
    want = fn(*args)
    same = torch.equal(mis, want[0]) and torch.equal(pos, want[1])
    matched = float((mis != 255).float().mean())
    say(f"[entry] __graft_entry_torch__.entry(): mis and pos {tuple(mis.shape)} equal to the "
        f"CPU run's: {same}, {matched:.4f} matched, {time.time() - t0:.1f} s")
    require(same and matched > 0.9, "the graft entry's probe differs from its CPU run")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if args not in ([], ["--kernels-only"]):
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2
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
    phase_entry()
    say(f"[time] phases 1-3 {time.time() - t_all:.1f} s")
    if args:
        return 0
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
        variant_launches["strand_rows.take"] = phase_modes(work, timings)
        say(f"[time] phase 7 {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_bench_200k(src, pair, codes)
        say(f"[time] phase 8 {time.time() - t0:.1f} s")
        t0 = time.time()
        phase_repeat(work)
        say(f"[time] phase 8b {time.time() - t0:.1f} s")
        t0 = time.time()
        variant_launches.update(phase_mesh(dev, work, src, timings))
        say(f"[time] phase 9 {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"[total] {time.time() - t_all:.1f} s")
    rows = [(name, name, launches[name]) for name in REPLACES]
    rows += [(name, VARIANTS[name][0], variant_launches[name]) for name in VARIANTS]
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": REPLACES[kernel][0],
         "replaces": VARIANT_REPLACES.get(name, REPLACES[kernel][1]), "launches": n,
         **timings[name]}
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
