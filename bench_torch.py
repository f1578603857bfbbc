#!/usr/bin/env python3
"""Benchmark of the torch port: bench.py's rows through pgrc_tpu_torch.

    python3 bench_torch.py [--device cuda|cpu]

Prints ONE JSON line with bench.py's keys and their meanings
({"metric", "value", "unit", "vs_baseline", ...}), beside the run's own
fields: `device` (nvidia-smi's name and power limit, the card count),
`versions` (torch, CUDA, nvcc), `codecs` (the stream coders present, which
decide archive bytes) and, for each row, `*_peak_device_mib` and the
archive's `*_sha256`. It imports nothing of JAX, of `pgrc_tpu` or of
bench.py: the inputs come from `pgrc_tpu_torch.synth`, bench.py's generator
with bench.py's seeds and sizes, so the files are bench.py's byte for byte.

Rows, in bench.py's order and with its steps: SE at PGRC_BENCH_READS
(200k; a cold encode, the median of 3, decode, validate), PE 2x, SE_ORD,
the repeat genome (with its matched fraction), the scale rows at
PGRC_BENCH_SCALE_READS and PGRC_BENCH_SCALE2_READS (median of 3, decode),
and the big row at PGRC_BENCH_BIG_READS (10M; PGRC_BENCH_BIG=0 skips it),
whose phases each run in a child process of their own:

    python3 bench_torch.py --big-row {cold,warm,validate,trace} SRC OUT [--device D]

`cold` is a fresh process's first encode (the CUDA context and the kernel
library's load inside the clock; nvcc too where the library is not built),
`warm` an encode after the child has made its context and loaded the
kernels, `validate` the streaming validator in a child that never imports
torch, `trace` one more encode under torch.profiler for its
device time. Each child reports its own peak RSS (`PeakRss`: VmHWM, or
/proc/self/statm sampled every 10 ms where the kernel has no VmHWM),
because a child's `ru_maxrss` starts from the parent's peak (the kernel
keeps it across the exec), which is what bench.py's children report. Input files are made in a spawned process, so the
generator's temporaries count in no row's RSS.

Each wall is the host clock around `encoder.encode`, with
`torch.cuda.synchronize()` before both reads. vs_baseline divides the SE
throughput by the reference PgRC binary's (`build-ref/PgRC -t 8`, the median
of 3 runs on the same input on this host, as bench_ref.sh times it); where
the binary does not run, by build-ref/baseline.json's figure, else by
bench.py's constant; `baseline_source` says which.

Gates: bits/base <= 0.1412 at >= 100k reads, the big row's encode peak RSS
<= 6144 MB and validate peak RSS <= 2048 MB, its warm throughput >= 0.6x
the SE row's, the scale row >= 0.8x, the parent's peak RSS <= 6144 MB
while the scale row is at most 2M reads, and vs_baseline >= 0.7 at >= 100k
reads. Once every row has run, a tripped gate prints the error JSON (every
row's figures under `partial`) and exits 1; a failed round trip stops the
run at once. Work files go to PGRC_BENCH_TMP (default `bench_tmp/` beside
this file).
"""
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# bench.py's fallback figure for the reference binary (Mbases/s, -t 8)
BASELINE_LOCAL_MBASES_S = 2.2
REF_BIN = os.path.join(HERE, "build-ref", "PgRC")
BASELINE_JSON = os.path.join(HERE, "build-ref", "baseline.json")
REFERENCE_BITS_PER_BASE = 0.1412  # reference archive on the 200k config
READ_LEN = 100
BIG_RSS_MB = 6144
BIG_VALIDATE_RSS_MB = 2048  # the streaming validator's budget at 10M reads
BIG_SCALING = 0.6           # the 10M row's throughput against the SE row's
SCALE_SCALING = 0.8
SCALE_RSS_MB = 6144
VS_BASELINE_FLOOR = 0.7
BIG_PHASES = ("cold", "warm", "validate", "trace")


def vm_hwm_mb():
    """This process's peak RSS in MB from /proc/self/status (VmHWM), None
    where the kernel does not report it."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return round(int(line.split()[1]) / 1024, 1)
    return None


def rss_now_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


class PeakRss:
    """This process's own peak RSS in MB: VmHWM where /proc/self/status
    has it (Linux); where the kernel does not report it, the largest
    resident size of /proc/self/statm, sampled every 10 ms by a daemon
    thread from the start. Not `ru_maxrss`: a child's starts at its
    parent's peak (the kernel keeps it across the exec)."""

    def __init__(self, every: float = 0.01):
        self.hwm = vm_hwm_mb() is not None
        self.source = "VmHWM" if self.hwm else f"statm every {every * 1e3:.0f} ms"
        self._max = rss_now_mb()
        if not self.hwm:
            threading.Thread(target=self._sample, args=(every,), daemon=True).start()

    def _sample(self, every):
        while True:
            self._max = max(self._max, rss_now_mb())
            time.sleep(every)

    def mb(self) -> float:
        if self.hwm:
            return vm_hwm_mb()
        return round(max(self._max, rss_now_mb()), 1)


def ru_maxrss_mb() -> float:
    import resource

    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)


def make_input(path, n_reads, genome_len, seed, pair=None, repeats=False):
    """bench.py's synthetic FASTQ (and pair file), in a spawned process,
    unless the files are there."""
    if os.path.exists(path) and (pair is None or os.path.exists(pair)):
        return
    from pgrc_tpu_torch.synth import synth_fastq

    p = multiprocessing.get_context("spawn").Process(
        target=synth_fastq, args=(path, n_reads, READ_LEN, genome_len),
        kwargs=dict(seed=seed, pair=pair, repeats=repeats))
    p.start()
    p.join()
    if p.exitcode != 0:
        raise RuntimeError(f"synth_fastq({path}) exited {p.exitcode}")


def sha256(path: str) -> str:
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


class Runner:
    """Encodes on one device: each wall on the host clock with the device
    synchronised before both reads, and the peak device memory of the
    encodes since `reset_peak` (None on the CPU)."""

    def __init__(self, dev):
        import torch

        from pgrc_tpu_torch.archive import encoder
        from pgrc_tpu_torch.config import PgRCParams

        self.torch, self.encoder, self.PgRCParams = torch, encoder, PgRCParams
        self.dev = dev
        self.cuda = dev.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def reset_peak(self):
        if self.cuda:
            self.sync()
            self.torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_device_mib(self):
        if not self.cuda:
            return None
        return round(self.torch.cuda.max_memory_allocated(self.dev) / 2**20, 1)

    def encode(self, src, out, **kw):
        self.sync()
        t0 = time.time()
        stats = self.encoder.encode(self.PgRCParams(src_fastq=src, output=out, **kw),
                                    device=self.dev)
        self.sync()
        return stats, time.time() - t0


def device_fields(dev) -> dict:
    """The device, the versions and the stream coders of this run."""
    import zlib

    import torch

    from pgrc_tpu_torch import native
    from pgrc_tpu_torch.kernels import build
    from pgrc_tpu_torch.streams import codecs

    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        name, power = (s.strip() for s in smi[0].split(","))
        device = {"platform": "gpu", "name": name, "power_limit": power,
                  "count": torch.cuda.device_count()}
    else:
        device = {"platform": "cpu", "name": None, "power_limit": None, "count": 0}
    try:
        out = subprocess.run([build.nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
        nvcc = out[-1] if out else None
    except (RuntimeError, OSError, subprocess.SubprocessError):
        nvcc = None
    return {
        "device": device,
        "versions": {"python": sys.version.split()[0], "torch": torch.__version__,
                     "cuda": torch.version.cuda, "nvcc": nvcc},
        "codecs": {"zstandard": codecs._zstd.__version__ if codecs._zstd else None,
                   "zlib": zlib.ZLIB_RUNTIME_VERSION, "lzma": True,
                   "native": native.get_lib() is not None},
    }


def time_reference(src: str, bases: int, tmpdir: str):
    """(Mbases/s, source, run seconds) of the reference binary on `src`
    (`bases` input bases):
    `build-ref/PgRC -t 8`, median of 3 runs, timed here; where it does not
    run, build-ref/baseline.json's figure, else bench.py's constant."""
    runs = []
    try:
        for _ in range(3):
            t0 = time.time()
            subprocess.run([REF_BIN, "-t", "8", "-i", src, os.path.join(tmpdir, "ref.pgrc")],
                           check=True, capture_output=True, timeout=1800)
            runs.append(time.time() - t0)
        return bases / 1e6 / statistics.median(runs), "build-ref/PgRC -t 8", runs
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[bench_torch] build-ref/PgRC did not run ({type(e).__name__}: {e}); "
              "falling back to the recorded baseline", file=sys.stderr)
    try:
        with open(BASELINE_JSON) as f:
            return float(json.load(f)["mbases_per_s"]), "build-ref/baseline.json", None
    except (OSError, ValueError, KeyError):
        return BASELINE_LOCAL_MBASES_S, "BASELINE_LOCAL_MBASES_S", None


def fail(msg, partial=None):
    """bench.py's error line, with what was measured before the failure."""
    print(json.dumps({"metric": "compression_throughput", "value": 0.0,
                      "unit": "Mbases/s", "vs_baseline": 0.0, "error": msg,
                      "partial": partial or {}}))
    return 1


def log(msg):
    print(f"[bench_torch] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda[:N] or cpu (no fallback)")
    ap.add_argument("--big-row", nargs=3, metavar=("PHASE", "SRC", "OUT"),
                    help=f"one phase of the big row in this process: {BIG_PHASES}")
    args = ap.parse_args(argv)
    peak = PeakRss()
    if args.big_row:
        return big_row(*args.big_row, peak, device=args.device)

    from pgrc_tpu_torch.device import resolve

    try:
        dev = resolve(args.device)
    except RuntimeError as e:
        return fail(str(e))
    n_reads = int(os.environ.get("PGRC_BENCH_READS", 200_000))
    n_scale = int(os.environ.get("PGRC_BENCH_SCALE_READS", 10 * n_reads))
    tmpdir = os.environ.get("PGRC_BENCH_TMP", os.path.join(HERE, "bench_tmp"))
    os.makedirs(tmpdir, exist_ok=True)
    src = os.path.join(tmpdir, f"bench_{n_reads}.fastq")
    pair = os.path.join(tmpdir, f"bench_{n_reads}_2.fastq")
    make_input(src, n_reads, max(n_reads * READ_LEN // 40, 200_000), 7, pair=pair)

    from pgrc_tpu_torch.archive import decoder

    fields = device_fields(dev)
    run = Runner(dev)
    extra = {}
    out = os.path.join(tmpdir, "bench.pgtc")
    # the first encode of the shape: nvcc (where the kernel library is not
    # built), the CUDA context, the allocator's first blocks
    _, cold_dt0 = run.encode(src, os.path.join(tmpdir, "w.pgtc"))
    runs = []
    run.reset_peak()
    for _i in range(3):
        stats, dt = run.encode(src, out)
        runs.append(dt)
    runs.sort()
    dt = runs[1]
    bases = stats.reads_total * stats.read_len
    mbases_s = bases / 1e6 / dt
    bits_per_base = stats.archive_bytes * 8 / bases
    log(f"SE {n_reads}: {runs} s, {mbases_s:.3f} Mbases/s, {bits_per_base:.4f} bits/base")

    t0 = time.time()
    n_out = decoder.decode_to_files(out, os.path.join(tmpdir, "bench_dec"))
    dec_dt = time.time() - t0
    rep = decoder.validate(out, src)
    if rep["errors"] or n_out != stats.reads_total:
        return fail("round-trip failed")
    # a tripped gate fails the run at its end, after every row was measured
    tripped = []
    if n_reads >= 100_000 and bits_per_base > REFERENCE_BITS_PER_BASE:
        tripped.append(f"bits_per_base {bits_per_base:.4f} regressed past "
                       f"reference {REFERENCE_BITS_PER_BASE}")
    result = {
        "metric": "compression_throughput",
        "value": round(mbases_s, 3),
        "unit": "Mbases/s",
        "vs_baseline": None,
        "bits_per_base": round(bits_per_base, 4),
        "archive_bytes": stats.archive_bytes,
        "sha256": sha256(out),
        "peak_device_mib": run.peak_device_mib(),
        "reads": stats.reads_total,
        "cold_mbases_s": round(bases / 1e6 / cold_dt0, 3),
        "run_spread_s": [round(r, 3) for r in runs],
        "decomp_mbases_s": round(bases / 1e6 / dec_dt, 3),
        "stage_times_s": {k: round(v, 2) for k, v in stats.stage_times.items()},
        **fields,
    }

    # --- PE row (cold: the first encode of PE's shapes) ---
    pe_out = os.path.join(tmpdir, "bench_pe.pgtc")
    _, pe_cold = run.encode(src, pe_out, pair_fastq=pair)
    run.reset_peak()
    pstats, pdt = run.encode(src, pe_out, pair_fastq=pair)
    pe_bases = pstats.reads_total * pstats.read_len
    if decoder.validate(pe_out, src, pair)["errors"]:
        return fail("PE round-trip failed", {**result, **extra})
    extra["pe_mbases_s"] = round(pe_bases / 1e6 / pdt, 3)
    extra["pe_cold_mbases_s"] = round(pe_bases / 1e6 / pe_cold, 3)
    extra["pe_bits_per_base"] = round(pstats.archive_bytes * 8 / pe_bases, 4)
    extra["pe_peak_device_mib"] = run.peak_device_mib()
    extra["pe_sha256"] = sha256(pe_out)
    log(f"PE: {pdt:.3f} s, {extra['pe_bits_per_base']} bits/base")

    # --- SE_ORD row ---
    ord_out = os.path.join(tmpdir, "bench_ord.pgtc")
    run.reset_peak()
    ostats, odt = run.encode(src, ord_out, preserve_order=True)
    if decoder.validate(ord_out, src)["errors"]:
        return fail("SE_ORD round-trip failed", {**result, **extra})
    extra["se_ord_mbases_s"] = round(bases / 1e6 / odt, 3)
    extra["se_ord_bits_per_base"] = round(ostats.archive_bytes * 8 / bases, 4)
    extra["se_ord_peak_device_mib"] = run.peak_device_mib()
    extra["se_ord_sha256"] = sha256(ord_out)
    log(f"SE_ORD: {odt:.3f} s, {extra['se_ord_bits_per_base']} bits/base")

    # --- the repeat genome: diverged ALU- and LINE-like copies and tandem
    # repeats, many equal k-mer keys per join run, more rescue work ---
    rep_src = os.path.join(tmpdir, f"bench_rep_{n_reads}.fastq")
    make_input(rep_src, n_reads, max(n_reads * READ_LEN // 40, 200_000), 11, repeats=True)
    rep_out = os.path.join(tmpdir, "bench_rep.pgtc")
    run.reset_peak()
    rstats, rdt = run.encode(rep_src, rep_out)
    if decoder.validate(rep_out, rep_src)["errors"]:
        return fail("repeat-data round-trip failed", {**result, **extra})
    extra["repeat_mbases_s"] = round(bases / 1e6 / rdt, 3)
    extra["repeat_bits_per_base"] = round(rstats.archive_bytes * 8 / bases, 4)
    extra["repeat_matched_frac"] = round(
        rstats.matched_count
        / max(rstats.reads_total - rstats.hq_count + rstats.matched_count, 1), 4)
    extra["repeat_peak_device_mib"] = run.peak_device_mib()
    extra["repeat_sha256"] = sha256(rep_out)
    log(f"repeat: {rdt:.3f} s, {extra['repeat_bits_per_base']} bits/base, matched "
        f"{extra['repeat_matched_frac']}")

    # --- scaling rows: a cold encode, then the median of 3 ---
    for label, n_s in (("scale", n_scale),
                       ("scale2", int(os.environ.get("PGRC_BENCH_SCALE2_READS", 0)))):
        if n_s <= n_reads:
            continue
        src_s = os.path.join(tmpdir, f"bench_{n_s}.fastq")
        make_input(src_s, n_s, max(n_s * READ_LEN // 40, 200_000), 9)
        out_s = os.path.join(tmpdir, "bench_scale.pgtc")
        _, cold_dt = run.encode(src_s, out_s)
        s_runs = []
        run.reset_peak()
        for _i in range(3):
            sstats, s_dt_i = run.encode(src_s, out_s)
            s_runs.append(s_dt_i)
        s_runs.sort()
        sdt = s_runs[1]
        s_bases = sstats.reads_total * sstats.read_len
        t0 = time.time()
        decoder.decode_to_files(out_s, os.path.join(tmpdir, "bench_scale_dec"))
        s_dec = time.time() - t0
        extra[f"{label}_reads"] = n_s
        extra[f"{label}_run_spread_s"] = [round(r, 3) for r in s_runs]
        extra[f"{label}_mbases_s"] = round(s_bases / 1e6 / sdt, 3)
        extra[f"{label}_cold_mbases_s"] = round(s_bases / 1e6 / cold_dt, 3)
        extra[f"{label}_bits_per_base"] = round(sstats.archive_bytes * 8 / s_bases, 4)
        extra[f"{label}_decomp_mbases_s"] = round(s_bases / 1e6 / s_dec, 3)
        extra[f"{label}_peak_device_mib"] = run.peak_device_mib()
        extra[f"{label}_sha256"] = sha256(out_s)
        extra[f"{label}_stage_times_s"] = {k: round(v, 2)
                                           for k, v in sstats.stage_times.items()}
        log(f"{label} {n_s}: {s_runs} s, {extra[f'{label}_mbases_s']} Mbases/s")

    # --- the big row: each phase in a child process of its own, so that
    # each peak RSS is that phase's ---
    n_big = int(os.environ.get("PGRC_BENCH_BIG_READS", 10_000_000))
    if os.environ.get("PGRC_BENCH_BIG", "1") != "0" and n_big > n_scale:
        src_b = os.path.join(tmpdir, f"bench_{n_big}.fastq")
        make_input(src_b, n_big, n_big * READ_LEN // 40, 9)
        out_b = os.path.join(tmpdir, "bench_big.pgtc")
        big = {}
        for phase in BIG_PHASES:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--big-row", phase, src_b,
                 out_b, "--device", args.device], capture_output=True, text=True)
            try:
                big[phase] = json.loads(p.stdout.strip().splitlines()[-1])
            except (IndexError, ValueError):
                return fail(f"{n_big}-read {phase} subprocess failed: {p.stderr[-300:]}",
                            {**result, **extra, "big": big})
            log(f"big {phase}: {big[phase]}")
            if big[phase].get("error"):
                return fail(f"{n_big}-read {phase}: {big[phase]['error']}",
                            {**result, **extra, "big": big})
        b_bases = n_big * READ_LEN
        warm, val, trace = big["warm"], big["validate"], big["trace"]
        extra["big_reads"] = n_big
        extra["big_mbases_s"] = round(b_bases / 1e6 / warm["wall_s"], 3)
        extra["big_cold_mbases_s"] = round(b_bases / 1e6 / big["cold"]["wall_s"], 3)
        extra["big_bits_per_base"] = warm["bits_per_base"]
        extra["big_peak_rss_mb"] = warm["peak_rss_mb"]
        extra["big_validate_rss_mb"] = val["peak_rss_mb"]
        extra["big_peak_device_mib"] = warm["peak_device_mib"]
        extra["big_sha256"] = warm["sha256"]
        extra["big_stage_times_s"] = warm["stage_times_s"]
        extra["big_import_rss_mb"] = warm["import_rss_mb"]
        extra["big_init_rss_mb"] = warm["init_rss_mb"]
        extra["big_ru_maxrss_mb"] = warm["ru_maxrss_mb"]
        extra["big_validate_import_rss_mb"] = val["import_rss_mb"]
        extra["big_validate_ru_maxrss_mb"] = val["ru_maxrss_mb"]
        extra["big_validate_s"] = val["wall_s"]
        extra["big_trace"] = {k: trace[k] for k in ("wall_s", "device_s", "busy_share",
                                                    "top")}
        if warm["peak_rss_mb"] > BIG_RSS_MB:
            tripped.append(f"{n_big}-read peak RSS {warm['peak_rss_mb']} MB exceeds "
                           f"{BIG_RSS_MB} MB")
        if val["peak_rss_mb"] > BIG_VALIDATE_RSS_MB:
            tripped.append(f"{n_big}-read validate RSS {val['peak_rss_mb']} MB exceeds "
                           f"{BIG_VALIDATE_RSS_MB} MB")
        if extra["big_mbases_s"] < BIG_SCALING * mbases_s:
            tripped.append(f"{n_big}-read throughput {extra['big_mbases_s']} fell below "
                           f"{BIG_SCALING}x the {n_reads}-read point ({mbases_s:.2f})")

    extra["peak_rss_mb"] = peak.mb()
    extra["rss_source"] = peak.source
    if "scale_mbases_s" in extra and extra["scale_mbases_s"] < SCALE_SCALING * mbases_s:
        tripped.append(f"scale throughput {extra['scale_mbases_s']} fell below "
                       f"{SCALE_SCALING}x the {n_reads}-read point ({mbases_s:.2f})")
    if extra["peak_rss_mb"] > SCALE_RSS_MB and n_scale <= 2_000_000:
        tripped.append(f"peak RSS {extra['peak_rss_mb']} MB exceeds {SCALE_RSS_MB} MB")

    baseline, source, ref_runs = time_reference(src, bases, tmpdir)
    result["vs_baseline"] = round(mbases_s / baseline, 3)
    extra["baseline_mbases_s"] = round(baseline, 3)
    extra["baseline_source"] = source
    extra["baseline_run_spread_s"] = ref_runs and [round(r, 3) for r in sorted(ref_runs)]
    if n_reads >= 100_000 and mbases_s / baseline < VS_BASELINE_FLOOR:
        tripped.append(f"vs_baseline {mbases_s / baseline:.3f} fell below the "
                       f"{VS_BASELINE_FLOOR} floor (median of 3 runs: {runs})")
    if tripped:
        return fail("; ".join(tripped), {**result, **extra})
    print(json.dumps({**result, **extra}))
    return 0


def big_row(phase: str, src_b: str, out_b: str, peak: PeakRss, device: str = "cuda") -> int:
    """One phase of the big row in this process, reported as one JSON line
    with this process's own wall time and peak RSS."""
    try:
        if phase not in BIG_PHASES:
            raise ValueError(f"unknown phase {phase!r} (one of {BIG_PHASES})")
        res = {}
        if phase == "validate":
            t0 = time.time()
            from pgrc_tpu_torch.archive import decoder

            res["import_rss_mb"] = round(rss_now_mb(), 1)
            log(f"validating {out_b} ({os.path.getsize(out_b)} B) against {src_b}")
            rep = decoder.validate(out_b, src_b)
            if rep["errors"]:
                print(json.dumps({"error": "round-trip failed"}))
                return 1
            res["wall_s"] = round(time.time() - t0, 1)
            res["reads"] = rep["reads"]
            if "torch" in sys.modules:
                raise RuntimeError("the validator imported torch: its RSS is not its own")
        else:
            from pgrc_tpu_torch.device import resolve

            dev = resolve(device)
            run = Runner(dev)
            res["import_rss_mb"] = round(rss_now_mb(), 1)
            if phase != "cold" and run.cuda:
                # the context and the kernel library, outside the clock
                from pgrc_tpu_torch.kernels import build

                run.torch.zeros(1, device=dev)
                build.lib()
            run.reset_peak()
            res["init_rss_mb"] = peak.mb()
            if phase == "trace":
                res.update(traced_encode(run, src_b, out_b))
            else:
                stats, wall = run.encode(src_b, out_b)
                b_bases = stats.reads_total * stats.read_len
                res["bits_per_base"] = round(stats.archive_bytes * 8 / b_bases, 4)
                res["wall_s"] = round(wall, 3)
                res["sha256"] = sha256(out_b)
                res["stage_times_s"] = {k: round(v, 2) for k, v in stats.stage_times.items()}
            res["peak_device_mib"] = run.peak_device_mib()
        res["peak_rss_mb"] = peak.mb()
        res["rss_source"] = peak.source
        res["ru_maxrss_mb"] = ru_maxrss_mb()
        print(json.dumps(res))
        return 0
    except Exception as e:  # surfaced as a bench failure by the parent
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}))
        return 1


def traced_encode(run, src, out) -> dict:
    """One encode under torch.profiler: its wall, the device time (the sum
    of the kernels' and copies' self time; None on the CPU), the busy share
    and the five largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.cuda else [])
    with profile(activities=acts) as prof:
        _, wall = run.encode(src, out)
    if not run.cuda:
        return {"wall_s": round(wall, 3), "device_s": None, "busy_share": None, "top": []}
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def self_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    busy = sum(self_us(e) for e in dev) / 1e6
    top = sorted(dev, key=self_us, reverse=True)[:5]
    return {"wall_s": round(wall, 3), "device_s": round(busy, 4),
            "busy_share": round(busy / wall, 4),
            "top": [[e.key[:60], round(self_us(e) / 1e3, 3), e.count] for e in top]}


if __name__ == "__main__":
    sys.exit(main())
