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
     and the peak device memory.
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


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version on the card, at the main path's
    shapes; returns {name: (max_abs_err, ms, plain_ms)}."""
    from pgrc_tpu.align.matcher import probe_offsets
    from pgrc_tpu.core import packed as ref_packed
    from pgrc_tpu_torch import state
    from pgrc_tpu_torch.kernels import kmer_hash, sweep, verify

    rng = np.random.default_rng(123)
    out = {}

    def record(name, run, run_plain, reps, note):
        got, want = run(), run_plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        ms, plain_ms = cuda_ms(run, reps), cuda_ms(run_plain, max(1, reps // 10))
        say(f"[kernel] {name} {note}: max_abs_err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        require(err == 0, f"{name} {note}: kernel differs from its plain version")
        return err, ms, plain_ms

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
    CPU: the two archives must be byte-identical."""
    import bench
    from pgrc_tpu.archive import decoder
    from pgrc_tpu_torch import cli, kernels

    src = os.path.join(work, f"se_{n_reads}.fastq")
    t0 = time.time()
    codes = bench.synth_fastq(src, n_reads, L, genome, seed=seed)
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
        idle = [k for k, v in launches.items() if v == 0]
        require(not idle, f"{label}: kernels never launched on the main path: {idle}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import pgrc_tpu_torch  # noqa: F401  (fails here when run outside the repo)

    t_all = time.time()
    smi = phase_device()
    phase_build()
    timings = phase_kernels(torch.device("cuda"))
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=HERE)
    try:
        launches = phase_se(*SE_RUNS[0], work=work, first=True)
        for run in SE_RUNS[1:]:
            phase_se(*run, work=work, first=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"[total] {time.time() - t_all:.1f} s")
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": timings[name][0],
         "ms": timings[name][1], "plain_ms": timings[name][2]}
        for name, (src, rep) in REPLACES.items()]}))
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
