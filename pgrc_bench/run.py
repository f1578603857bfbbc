"""One run of one cell of the benchmark of `pgrc_tpu_torch` on one card.

    python3 pgrc_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell (`workloads` in BENCHMARK.json) names a
configuration, whose file holds the input's sizes and the encoder's flags,
and a traffic mix, `pgrc_bench/traffic/<name>.json`, the input's quality
profile. Every metric is read from the run's record by its own reader,
`pgrc_bench/metrics/<name>.py`. So a cell, a configuration, a mix or a metric
is added with new files and entries, and no edit here.

The run, in one process:

1. Set-up (`setup_s`): the input FASTQ is generated from the seed into a
   fresh directory under $TMPDIR by `gen.py` in a process of its own, while
   this one imports torch and the port, makes the CUDA context and loads the
   port's kernel and native libraries (each built inside the checkout when
   absent). Then the resident-size base is taken and one warm-up encode of
   the cell's input runs; its peak above the base is `encode_rss_mb`.
2. The window: `archive.encoder.encode` of that input, back to back, each
   writing an archive of its own, until `--seconds` have passed; the encode
   in flight at the end finishes and counts. With `--trace 1` the window
   runs under torch.profiler and the encoder records each stage's own peak
   resident size (PGRC_TPU_RSS_TRACE=1).
3. The reference (`reference.py`) decodes every distinct archive the window
   wrote with its frozen decoder copy and holds it to the guarantee of the
   mode the configuration asks for (`guarantee`): the reads back as a
   multiset (of pairs, or of pairs without their mates' order, in the pair
   modes), and in input order under `-o`.
4. The last line of standard output is the result as one JSON object; the
   numbers compared, beside their limits, are its last key and the last
   lines of standard error.

It exits non-zero without a result where there is no card (or fewer than
the cell asks for), and where JAX or the JAX package is loaded at the end.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = os.path.basename(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pgrc_bench import devtrace, reference, rss  # noqa: E402

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "pgrc_tpu")
# each number compared, and its limit: an exact comparison
LIMITS = {"reads_differ": 0, "archives_failed": 0, "reads_out_of_order": 0}
SPAN = "pgrc_bench.encode."
# the caches of the libraries under the port, at fixed places in the checkout
# (the port builds its own kernel and native libraries inside its package)
CACHE_DIR = ".bench_cache"
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
             "CUDA_CACHE_PATH": "nv_compute"}


class NoCard(RuntimeError):
    pass


# ---------------------------------------------------------------- the data

def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(root: str, workload: str) -> dict:
    """The cell, its configuration and its traffic mix, found by name."""
    bench = load_benchmark(root)
    cell = _named(bench["workloads"], workload, "workload")
    entry = _named(bench["configs"], cell["config"], "config")
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, BENCH, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return {"bench": bench, "cell": cell, "config": config, "traffic": traffic}


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics the cell reports: its end-to-end ones, or with the trace
    its per-layer ones; a metric with `workloads` only in those cells."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def load_reader(root: str, name: str):
    """`read(record)` of `pgrc_bench/metrics/<name>.py`."""
    path = os.path.join(root, BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"{BENCH}_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def input_files(config: dict, work: str) -> list[str]:
    n = 2 if config["paired"] else 1
    return [os.path.join(work, f"reads_{i + 1}.fastq") for i in range(n)]


def generator_spec(config: dict, traffic: dict, seed: int, files: list[str]) -> dict:
    """`gen.synth_fastq`'s arguments for the cell: the configuration's sizes
    (its `reads` count both files of a pair) and genome, the mix's profile,
    and the run's seed, which draws the reads."""
    return {
        "path": files[0], "pair": files[1] if len(files) > 1 else None,
        "n_reads": config["reads"] // len(files), "read_len": config["read_len"],
        "genome_len": config["genome_len"], "repeats": config["repeats"],
        "genome_seed": config.get("genome_seed"),
        "seed": seed % 2**64, "lq_share": traffic["lq_share"],
        "error_rate": traffic["error_rate"], "n_share": traffic["n_share"],
    }


def parse_flags(flags: list[str]) -> argparse.Namespace:
    """The configuration's encoder flags, parsed as `pgrc_tpu_torch.cli`
    parses its compression flags."""
    ap = argparse.ArgumentParser(prog="flags")
    for flag in "osQSIArnV":
        ap.add_argument("-" + flag, action="store_true")
    for flag in "qgMpl":
        ap.add_argument("-" + flag, type=int, default=None)
    ap.add_argument("-c", type=int, default=2)
    ap.add_argument("-t", type=int, default=0)
    ap.add_argument("-v", action="count", default=0)
    return ap.parse_args(flags)


def guarantee(config: dict) -> reference.Guarantee:
    """What the configuration's archives have to give back: the guarantee
    of the mode its flags and its paired input ask for."""
    a = parse_flags(config["flags"])
    return reference.Guarantee.of(config["paired"], preserve_order=a.o, single_reads=a.S,
                                  ignore_pair_order=a.s or a.I)


def params_for(a: argparse.Namespace, files: list[str], archive: str):
    """The encoder's parameters for parsed flags, built as
    `pgrc_tpu_torch.cli.main` builds them for `-i <files> <archive>`."""
    from pgrc_tpu_torch.config import PgRCParams

    params = PgRCParams(
        src_fastq=files[0],
        pair_fastq=files[1] if len(files) > 1 else "",
        output=archive,
        preserve_order=a.o,
        single_reads_mode=a.S,
        ignore_pair_order=a.s or a.I,
        compression_level=a.c,
        error_limit_promils=a.q,
        simplified_suffix_mode=not a.Q,
        gen_quality_coef=a.g / 100.0 if a.g is not None else None,
        min_chars_per_mismatch=a.M,
        target_pg_match_length=a.p,
        separate_n_reads=not a.n,
        n_reads_lq=a.n,
        disable_revcomp_pair=a.r,
        verbosity=a.v,
        dump_validation_files=a.V,
        rev_offset_mismatches=not a.A,
    )
    if a.l is not None:
        params.prematch_accept_mis = a.l
    return params


# ---------------------------------------------------------------- the run

def _forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def _card_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _set_caches(root: str) -> None:
    for var, sub in CACHE_ENV.items():
        path = os.path.join(root, CACHE_DIR, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float | None = None) -> dict:
    """One run; returns the result line as a dict. `device="cpu"` runs the
    port's plain versions on the CPU without looking for a card (the tests'
    small cells); a run of the benchmark always asks for `cuda`."""
    t0 = time.perf_counter() if t0 is None else t0
    spec = load_cell(root, workload)
    bench, cell, config, traffic = spec["bench"], spec["cell"], spec["config"], spec["traffic"]
    _set_caches(root)
    info = {"cell": workload, "seed": seed, "seconds": seconds, "trace": int(trace)}
    work = tempfile.mkdtemp(prefix="pgrc_bench_")
    files = input_files(config, work)
    gen = subprocess.Popen([sys.executable, os.path.join(HERE, "gen.py"),
                            json.dumps(generator_spec(config, traffic, seed, files))])
    rss_trace = os.environ.get("PGRC_TPU_RSS_TRACE")
    try:
        if trace:
            os.environ["PGRC_TPU_RSS_TRACE"] = "1"
        return _run(root, bench, cell, config, files, work, gen, seconds, trace,
                    device, t0, info)
    finally:
        if gen.poll() is None:
            gen.kill()
        gen.wait()
        shutil.rmtree(work, ignore_errors=True)
        if rss_trace is None:
            os.environ.pop("PGRC_TPU_RSS_TRACE", None)


def _run(root, bench, cell, config, files, work, gen, seconds, trace, device,
         t0, info) -> dict:
    t = time.perf_counter()
    import torch

    from pgrc_tpu_torch import native
    from pgrc_tpu_torch.archive import encoder
    from pgrc_tpu_torch.device import resolve
    from pgrc_tpu_torch.streams import container
    from pgrc_tpu_torch.utils import logchan

    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        raise NoCard(f"the cell asks for {cell['chips']} card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    dev = resolve(device)
    info["import_s"] = time.perf_counter() - t
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        t = time.perf_counter()
        torch.zeros(1, device=dev)
        sync()
        info["context_s"] = time.perf_counter() - t
        from pgrc_tpu_torch.kernels import build as kbuild

        t = time.perf_counter()
        info["kernel_build_s"] = kbuild.build().seconds
        kbuild.lib()
        info["kernel_lib_s"] = time.perf_counter() - t
    t = time.perf_counter()
    native.get_lib()   # builds the library where absent; raises where it cannot
    info["native_lib_s"] = time.perf_counter() - t
    flags = parse_flags(config["flags"])
    logchan.set_verbosity(flags.v)
    container.set_threads(flags.t)

    t = time.perf_counter()
    if gen.wait(timeout=900) != 0:
        raise RuntimeError(f"the input generator exited with {gen.returncode}")
    info["generator_wait_s"] = time.perf_counter() - t
    sampler = rss.PeakSampler()
    t = time.perf_counter()
    encoder.encode(params_for(flags, files, os.path.join(work, "warmup.pgtc")), device=dev)
    sync()
    info["warmup_s"] = time.perf_counter() - t
    # one encode's peak, as a process that compresses one input has it: the
    # resident size creeps with each further encode of one process
    warmup_peak = sampler.peak_mb()
    setup_s = time.perf_counter() - t0

    window = []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    with prof if prof is not None else contextlib.nullcontext():
        sync()
        first = time.perf_counter()
        while True:
            i = len(window)
            path = os.path.join(work, f"window_{i}.pgtc")
            params = params_for(flags, files, path)
            span = record_function(f"{SPAN}{i}") if trace else contextlib.nullcontext()
            sync()
            start = time.perf_counter()
            with span:
                stats = encoder.encode(params, device=dev)
                sync()
            end = time.perf_counter()
            window.append({
                "start_s": start - first, "end_s": end - first, "archive": path,
                "bases": config["reads"] * config["read_len"],
                "stage_times": dict(stats.stage_times),
                "stage_rss_mb": dict(stats.stage_rss_mb) if stats.stage_rss_mb else None,
            })
            if end - first >= seconds:
                break
    rss_peak = sampler.stop()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = None
    if trace:
        dev_items, spans = devtrace.events(prof, SPAN)
        summary = devtrace.summarise(dev_items, spans, [w["stage_times"] for w in window])
        del dev_items, spans
    del prof, stats
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and its readings are taken
    t = time.perf_counter()
    checks, failed = judge_window(window, files, guarantee(config))
    info["reference_s"] = time.perf_counter() - t
    record = {
        "setup_s": setup_s, "encodes": window, "rss_base_mb": sampler.base_mb,
        "rss_warmup_peak_mb": warmup_peak, "rss_peak_mb": rss_peak, "trace": summary,
    }
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = load_reader(root, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": cell["chips"] if cuda else 0,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": failed == 0 and all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(window), "failed": failed, "metrics": metrics,
              "device": device_info}
    if summary:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        result["idle_by_stage"] = summary["idle_by_stage"]
    result["checks"] = checks
    info.update({
        "setup_s": setup_s, "card": _card_limit() if cuda else None,
        "rss_base_mb": sampler.base_mb, "rss_warmup_peak_mb": warmup_peak,
        "rss_peak_mb": rss_peak, "encode_walls_s": [w["end_s"] - w["start_s"] for w in window],
        "stage_times_s": [w["stage_times"] for w in window],
        "archive_sha256": sorted({w.get("sha256") for w in window} - {None}),
    })
    print("[bench] " + json.dumps(info), flush=True)
    return result


def judge_window(window: list[dict], files: list[str],
                 g: reference.Guarantee | None = None):
    """Judge every archive the window wrote by the guarantee `g` (by default
    SE's for one input file, PE's for two); archives with the same bytes
    decode alike, so each distinct one is decoded once. Returns the numbers
    compared, each beside its limit, and how many encodes failed. An archive
    that does not decode, or whose mode is not the guarantee's, counts in
    `archives_failed`."""
    if not reference.native_ready():
        raise RuntimeError("the reference decoder's native library did not build")
    g = g or reference.Guarantee.of(paired=len(files) == 2)
    t = time.perf_counter()
    want = reference.expected(files, g)
    print(f"[bench] reference: the input's keys in {time.perf_counter() - t:.3f} s",
          flush=True)
    verdicts, failed, unreadable = {}, 0, 0
    worst = dict.fromkeys(["reads_differ"] + (["reads_out_of_order"] if g.in_order else []), 0)
    for w in window:
        if not os.path.exists(w["archive"]):
            unreadable += 1
            failed += 1
            continue
        h = w["sha256"] = _sha256(w["archive"])
        if h not in verdicts:
            name = os.path.basename(w["archive"])
            t = time.perf_counter()
            try:
                verdicts[h] = reference.verdict(w["archive"], want, g)
                print(f"[bench] reference: {name} decoded and compared in "
                      f"{time.perf_counter() - t:.3f} s", flush=True)
            except reference.ModeMismatch as e:
                print(f"[bench] {name}: {e}", file=sys.stderr, flush=True)
                verdicts[h] = None
            except Exception as e:  # any fault of a decode is the archive's
                print(f"[bench] {name} does not decode: {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                verdicts[h] = None
        if verdicts[h] is None:
            unreadable += 1
            failed += 1
        else:
            for k, v in verdicts[h].items():
                worst[k] = max(worst[k], v)
            failed += any(verdicts[h].values())
        w["archive_bytes"] = os.path.getsize(w["archive"])
    if unreadable == len(window):
        # nothing came back: every input read (pair) is missing, and out of place
        worst = dict.fromkeys(worst, want.keys.size)
    counts = {"reads_differ": worst.pop("reads_differ"), "archives_failed": unreadable, **worst}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in counts.items()}, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), t0=_T0)
    except NoCard as e:
        print(f"[bench] no result: {e}", file=sys.stderr)
        return 3
    found = _forbidden_modules()
    if found:
        print(f"[bench] no result: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
