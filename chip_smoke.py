#!/usr/bin/env python3
"""Smoke run of the torch port (pgrc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with its times; the first failure exits nonzero:
  1. device: the card's name and power limit (nvidia-smi), torch, CUDA,
     nvcc, and whether the host layer's native library loaded;
  2. build: the CUDA kernels from pgrc_tpu_torch/kernels/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes — outputs must be bit-equal — and both timed;
  4. SE 200k (bench.py's headline input): compress through the port's CLI
     on the card, decode with pgrc_tpu's decoder, require an exact multiset
     round trip, every kernel launched, and bits/base <= 0.1412;
  5. SE 2M (bench.py's scale input): the same, with bits/base <= 0.1384
     and the peak device memory;
  6. large pg: the matcher with the encoder's lazy index where the blocked
     index and the wide probe trigger on their own, a 300M-symbol pg (2
     index blocks, int32 positions) and a 2.3G-symbol pg (9 blocks, int64
     positions), 2^20 planted reads each: >= 99% back at their planted
     position and strand, every match re-verified on the host, one kernel B
     launch per block. On the same pgs, kernel B at a block start (int32 and
     int64) and kernel A's int64 form against their plain versions;
  7. modes at 30k reads (bench.synth_fastq, with a pair file): SE -l 2, PE,
     MIN_PE, SE_ORD, PE_ORD, and SE with the sweep and index caps lowered
     (a partitioned sweep, a blocked index): the card's archive
     byte-identical to the port's CPU run, an exact decode, kernels launched;
  8. PE 2x200k and SE_ORD 200k (bench.py's inputs): exact round trips,
     bits/base, Mbases/s and peak device memory.
The last lines are the kernels' JSON record, the card's nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA card it exits 2 and prints no
result. It imports nothing of JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
L = 100
SE_RUNS = (  # label, reads, genome, seed, bits/base gate, pgrc_tpu's archive bytes
    ("SE 200k", 200_000, 500_000, 7, 0.1412, 346_639),
    ("SE 2M", 2_000_000, 5_000_000, 9, 0.1384, None),
)
REPLACES = {
    "verify_best": ("pgrc_tpu_torch/kernels/csrc/verify.cu", "exp_pallas_verify.py:91"),
    "index_kmer_hash": ("pgrc_tpu_torch/kernels/csrc/kmer_hash.cu",
                        "pgrc_tpu/align/matcher.py:469"),
    "probe_kmer_hash": ("pgrc_tpu_torch/kernels/csrc/kmer_hash.cu",
                        "pgrc_tpu/align/matcher.py:213"),
    "sweep_roll_entries": ("pgrc_tpu_torch/kernels/csrc/sweep_round.cu",
                           "pgrc_tpu/overlap/greedy_scs.py:235"),
}
# variants: JSON name -> (kernel, the launch counter of the path that runs it)
VARIANTS = {
    "verify_best.int64": ("verify_best", "verify_best.int64"),
    "index_kmer_hash.block": ("index_kmer_hash", "index_kmer_hash"),
    "index_kmer_hash.int64": ("index_kmer_hash", "index_kmer_hash.int64"),
}
# the main path's int32 kernels: SE 200k and every mode launch each of them
MAIN_KERNELS = tuple(REPLACES)
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


def phase_device() -> str:
    from pgrc_tpu import native
    from pgrc_tpu.streams import codecs
    from pgrc_tpu_torch.kernels import build

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
    say(f"[build] {os.path.relpath(b.path, HERE)} in {b.seconds:.1f} s")
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line.lower():
            say(f"[build]   {line.strip()}")


def record(name, run, run_plain, reps, note):
    """One kernel against its plain version on the same inputs: bit-equal
    outputs required, both timed. -> (max_abs_err, ms, plain_ms)."""
    got, want = run(), run_plain()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ms, plain_ms = cuda_ms(run, reps), cuda_ms(run_plain, max(1, reps // 10))
    say(f"[kernel] {name} {note}: max_abs_err {err}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    require(err == 0, f"{name} {note}: kernel differs from its plain version")
    return err, ms, plain_ms


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version on the card, at the main path's
    shapes; returns {name: (max_abs_err, ms, plain_ms)}."""
    from pgrc_tpu.align.matcher import probe_offsets
    from pgrc_tpu.core import packed as ref_packed
    from pgrc_tpu_torch import state
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
    lanes, _ = state.lanes_to_device(*ref_packed.pack_lanes(reads), dev)
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
                          f"R={R} S={S} n_verify={nv}")
    out["verify_best"] = rows[6]

    # B: index_kmer_hash over the 5M-symbol pg, k = 32, k1 = 4
    m = (pg_lanes.numel() - 1) * 16 // 4
    args = (pg_lanes, 32, 4, pg_len, m)
    out["index_kmer_hash"] = record(
        "index_kmer_hash", lambda: kmer_hash.index_kmer_hash(*args),
        lambda: kmer_hash.index_kmer_hash_plain(*args), 20, f"m={m} k=32 k1=4")

    # C: probe_kmer_hash, R = 2^18 rows, S = 23 offsets
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    out["probe_kmer_hash"] = record(
        "probe_kmer_hash", lambda: (kmer_hash.probe_kmer_hash(lanes, offs_t, 32),),
        lambda: (kmer_hash.probe_kmer_hash_plain(lanes, offs_t, 32),), 20,
        f"R={R} S={S} k=32")

    # D: sweep_roll_entries, n = 2^18 rows, rounds 1..4, without and with N
    n = 1 << 18
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    rows = {}
    for with_n in (False, True):
        if with_n:
            codes[rng.random(n) < 0.05, 7] = 4
        lanes_d, nmask_d = state.lanes_to_device(*ref_packed.pack_lanes(codes), dev)
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
        say(f"[kernel] sweep_roll_entries n={n} rounds 1-4 N={with_n}: max_abs_err "
            f"{err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rows[with_n] = (err, ms, plain_ms)
    out["sweep_roll_entries"] = rows[True]
    return out


def read_decoded(path: str, read_len: int):
    from pgrc_tpu.utils import dna

    raw = np.fromfile(path, dtype=np.uint8)
    return dna.SYM2VAL[raw.reshape(-1, read_len + 1)[:, :read_len]]


def phase_se(label, n_reads, genome, seed, gate, ref_bytes, work, first,
             device="cuda"):
    """Compress through the port's CLI on `device`, decode, check. On the
    first run the launch counts are reset before and read after the encode,
    and the same input is also compressed with the plain versions on the
    CPU: the two archives must be byte-identical, and bench.py's pair file
    is written beside the input for phase 8. -> (launches, src, pair, codes)."""
    import bench
    from pgrc_tpu.archive import decoder
    from pgrc_tpu_torch import cli, kernels

    src = os.path.join(work, f"se_{n_reads}.fastq")
    pair = os.path.join(work, f"se_{n_reads}_2.fastq") if first else None
    t0 = time.time()
    codes = bench.synth_fastq(src, n_reads, L, genome, seed=seed, pair=pair)
    gen_s = time.time() - t0
    archive = os.path.join(work, f"se_{n_reads}.pgtc")
    report = os.path.join(work, f"se_{n_reads}.tsv")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if first:
        kernels.reset_launches()
    t0 = time.time()
    rc = cli.main(["--device", device, "-R", report, "-i", src, archive])
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
        f"{ref_bytes or 'not recorded'}), "
        f"{bits:.6f} bits/base (gate {gate}), encode {enc_s:.2f} s = "
        f"{bases / 1e6 / enc_s:.2f} Mbases/s, decode {dec_s:.2f} s = "
        f"{bases / 1e6 / dec_s:.2f} Mbases/s, input synth {gen_s:.1f} s, "
        f"peak device memory {peak_mb:.0f} MiB, stage s {stages}, "
        f"exact multiset round trip {same}, launches {launches}")
    require(same, f"{label}: decoded reads differ from the input")
    require(cpu_same is not False, f"{label}: the card's archive differs from the CPU's")
    require(bits <= gate, f"{label}: {bits:.6f} bits/base exceeds {gate}")
    if first:
        idle = [k for k in MAIN_KERNELS if launches[k] == 0]
        require(not idle, f"{label}: kernels never launched on the main path: {idle}")
    return launches, src, pair, codes


def fastq_codes(path: str):
    """The read lines of a FASTQ file (4 lines a record) as codes [n, L]."""
    from pgrc_tpu.utils import dna

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
    """Decode with pgrc_tpu's decoder and compare with the input reads:
    in order ("order"), as a multiset of pairs ("pairs"), of unordered pairs
    ("unordered pairs") or of reads ("reads"). Never decoder.validate, which
    accepts swapped bytes and swapped pairs. -> (exact, decode seconds)."""
    from pgrc_tpu.archive import decoder

    t0 = time.time()
    n = decoder.decode_to_files(archive, prefix)
    dec_s = time.time() - t0
    return _same_reads(prefix, n, kind, inputs), dec_s


def _same_reads(prefix: str, n: int, kind: str, inputs: list) -> bool:
    from pgrc_tpu.archive import decoder

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


def phase_large_pg(dev, label, pg_len, seed, lane_off):
    """The blocked index (and, past 2^31 symbols, the wide probe) where they
    trigger on their own. One pg serves the kernel checks and the match run.
    -> ({variant: (max_abs_err, ms, plain_ms)}, launches of the match run)."""
    from pgrc_tpu.align.matcher import probe_offsets
    from pgrc_tpu.config import PgRCParams, matching_chars_correction
    from pgrc_tpu.core import packed as ref_packed
    from pgrc_tpu_torch import kernels, state
    from pgrc_tpu_torch.align import matcher
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
    reads[rc] = ref_packed.revcomp_codes_matrix(reads[rc])
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
    out["index_kmer_hash.int64" if wide else "index_kmer_hash.block"] = record(
        "index_kmer_hash", lambda: kmer_hash.index_kmer_hash(*args),
        lambda: kmer_hash.index_kmer_hash_plain(*args), 10,
        f"{'int64' if wide else 'int32'} block at lane_off {lane_off} (positions "
        f"{lane_off * 16}..{lane_off * 16 + m * 4 - 4}), m={m} k={k} k1=4")
    if wide:
        R, offs = 1 << 18, probe_offsets(L, k, 3)
        S = len(offs)
        true_st = rng.integers(PAST_INT32, pg_len - L + 1, size=R)
        vr = pg[true_st[:, None] + np.arange(L)[None, :]]
        vmask = rng.random(vr.shape) < 0.02
        vr[vmask] = (vr[vmask] + 1) % 4
        lanes, _ = state.lanes_to_device(*ref_packed.pack_lanes(vr), dev)
        cand = np.where(rng.random((R, S)) < 0.5,
                        true_st[:, None] + rng.integers(-2, 3, size=(R, S)),
                        rng.integers(PAST_INT32 - L, pg_len, size=(R, S)))
        start_all = torch.from_numpy(cand.astype(np.int64)).to(dev)
        in_range = torch.from_numpy(rng.random((R, S)) < 0.7).to(dev)
        vargs = (lanes, start_all, in_range, pg_lanes, pg_len - L, L, max_mis, 6)
        out["verify_best.int64"] = record(
            "verify_best", lambda: verify.verify_best(*vargs),
            lambda: verify.verify_best_plain(*vargs), 20,
            f"int64 R={R} S={S} n_verify=6, starts {int(cand.min())}..{int(cand.max())}")
        del lanes, start_all, in_range
    del pg_lanes
    free_card()
    say(f"[{label}] kernel checks {time.time() - t0:.1f} s")

    index = matcher.build_index(pg, k=k, device_sort=True)
    blocks = -(-(pg_len - k + 1) // (matcher._MAX_INDEX_BLOCK * index.k1))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    res = matcher.match_reads(reads, index, pg, max_mis, cap=prm.match_cap,
                              accept_mis=0, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    free_card()
    hit = (res.pos == st) & (res.rc == rc)
    got = np.nonzero(res.pos >= 0)[0]
    win = pg[res.pos[got, None] + np.arange(L)[None, :]]
    ori = reads[got]
    ori = np.where(res.rc[got, None], ref_packed.revcomp_codes_matrix(ori), ori)
    exact = (win != ori).sum(axis=1) == res.mis[got]
    b_key, a_key = (("index_kmer_hash.int64", "verify_best.int64") if wide
                    else ("index_kmer_hash", "verify_best"))
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
    other = ("index_kmer_hash", "verify_best") if wide else (
        "index_kmer_hash.int64", "verify_best.int64")
    require(launches[a_key] > 0 and launches["probe_kmer_hash"] > 0
            and not any(launches[o] for o in other),
            f"{label}: the probe did not run on its {'int64' if wide else 'int32'} kernels")
    return out, launches


def phase_modes(work: str) -> None:
    """Every archive mode on the card against the port's own CPU run."""
    import bench
    from pgrc_tpu_torch import cli, kernels
    from pgrc_tpu_torch.align import matcher
    from pgrc_tpu_torch.overlap import greedy_scs

    src, pair = (os.path.join(work, f"modes{i}.fastq") for i in (1, 2))
    codes = {"{s}": bench.synth_fastq(src, MODE_READS, L, MODE_GENOME, seed=5, pair=pair),
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
    from pgrc_tpu_torch import cli

    inputs = {"{s}": codes, "{p}": fastq_codes(pair)}
    for label, argv_t, kind, ref_bpb in BENCH_200K:
        argv = [{"{s}": src, "{p}": pair}.get(a, a) for a in argv_t]
        ins = [inputs[a] for a in argv_t if a in inputs]
        archive = os.path.join(os.path.dirname(src), label.replace(" ", "_") + ".pgtc")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        require(cli.main(["--device", "cuda", *argv, archive]) == 0,
                f"{label}: compress failed")
        torch.cuda.synchronize()
        enc_s = time.time() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        exact, dec_s = decodes_exactly(archive, archive + ".dec", kind, ins)
        bases = sum(c.size for c in ins)
        size = os.path.getsize(archive)
        say(f"[{label}] archive {size} B, {size * 8 / bases:.6f} bits/base (pgrc_tpu "
            f"with zstd: {ref_bpb}), encode {enc_s:.2f} s = {bases / 1e6 / enc_s:.2f} "
            f"Mbases/s, decode {dec_s:.2f} s = {bases / 1e6 / dec_s:.2f} "
            f"Mbases/s, peak device memory {peak_mb:.0f} MiB, exact round trip "
            f"({kind}) {exact}")
        require(exact, f"{label}: the decoded reads differ from the input")


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
    say(f"[time] phases 1-3 {time.time() - t_all:.1f} s")
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=HERE)
    try:
        t0 = time.time()
        launches, src, pair, codes = phase_se(*SE_RUNS[0], work=work, first=True)
        for run in SE_RUNS[1:]:
            phase_se(*run, work=work, first=False)
        say(f"[time] phases 4-5 {time.time() - t0:.1f} s")
        variant_launches = {}
        for label, pg_len, seed, lane_off in LARGE_PGS:
            t0 = time.time()
            got, path_launches = phase_large_pg(dev, label, pg_len, seed, lane_off)
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
         "replaces": REPLACES[kernel][1], "launches": n,
         "max_abs_err": timings[name][0], "ms": timings[name][1],
         "plain_ms": timings[name][2]}
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
