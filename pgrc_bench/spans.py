"""The program's own spans and counters in the benchmark.

`pgrc_tpu_torch.utils.trace` records every encode: a span for each stage
and sub-stage, on the main thread and on the encode's worker threads, and
its counters (host<->device bytes, device reads, kernel launches). The
per-layer readers `metrics/stage_s.selfmatch*.py`, `stage_s.pgseq_write.py`,
`stage_s.bad.py`, `h2d_mb.py` and `device_syncs.py` read them through
`window_encodes`: from a window record's `spans` and `counters` where it
has them, else from the program's recorder in this process (the last
encodes of `trace.recent()`, each matched to its window record by its
`stage_times`). A program without the recorder, or records that match no
recorded encode, read None.

With the profiler on, each span is also a `record_function` event of its
name, so the root span `encode` gives, per encode, the offset of the
recorder's clock (perf_counter) against the profiler's: `clock_offsets`.
`label_idle` puts each idle piece of the device down to the deepest
main-thread span open over it (`match/match.pass1`, `chain/selfmatch.wait`),
and `summarise` sums, as `idle_unspanned_s`, the idle time that no
main-thread span below `encode` covers.

    python3 pgrc_bench/spans.py --workload <cell> --seed <n> --seconds <s> [--device cuda]

runs `run.py`'s traced run of the cell and prints, before its result line,
`[spans] {...}`: `clock_offset_spread_ms`, `idle_unspanned_s`, the idle
gaps labelled by span, the idle seconds by label, spans and counters per
encode. The numbers are of the window's encodes on the profiler's clock.
With `--sync-check` it runs instead one encode of the cell's input, after
a warm-up, under `torch.cuda.set_sync_debug_mode("warn")`, and prints
`[sync] {...}`: the synchronising calls torch warned of, by source line,
beside the encode's `device_syncs` and `h2d_copies`.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import traceback
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pgrc_bench import devtrace  # noqa: E402

# the encoder's stages, the children of `encode` that `stage_times` times
STAGES = ("input", "div", "pgdiv", "good", "match", "bad", "order", "pgseq")
TRACE_MODULE = "pgrc_tpu_torch.utils.trace"
LABEL_MAX = 64


# ---------------------------------------------------------------- reading

def program_encodes(n: int) -> list[dict] | None:
    """The last n encodes the program's recorder holds in this process,
    exported, oldest first; None without such a recorder or encodes."""
    trace = sys.modules.get(TRACE_MODULE)
    recent = getattr(trace, "recent", None)
    if recent is None or n <= 0:
        return None
    got = [r.export() for r in recent() if r.root.name == "encode"][-n:]
    return got if len(got) == n else None


def _stages_match(stage_times: dict | None, enc: dict) -> bool:
    """Whether an exported encode has a window record's stage_times: each
    stage's span lasts exactly the record's seconds (a stage without a span
    reads 0.0, as `match` on a checkpoint path)."""
    if not stage_times:
        return False
    spans = enc["spans"]
    main = spans[0]["thread"]
    got = {s["name"]: s["dur_s"] for s in spans
           if s["parent"] == 0 and s["thread"] == main and s["name"] in STAGES}
    return set(got) <= set(stage_times) and all(
        got.get(k, 0.0) == v for k, v in stage_times.items())


def window_encodes(record: dict) -> list[dict] | None:
    """[{spans, counters}] of the window's encodes, or None where any lacks
    them."""
    encodes = record.get("encodes") or []
    if not encodes:
        return None
    if all("spans" in e and "counters" in e for e in encodes):
        return [{"spans": e["spans"], "counters": e["counters"]} for e in encodes]
    got = program_encodes(len(encodes))
    if got is None or not all(_stages_match(e.get("stage_times"), g)
                              for e, g in zip(encodes, got)):
        return None
    return got


def span_seconds(enc: dict, name: str) -> float:
    """The seconds of an encode's spans named `name`, summed (0 where none
    opened)."""
    return sum(s["dur_s"] for s in enc["spans"] if s["name"] == name)


def mean(record: dict, value) -> float | None:
    """The mean over the window's encodes of value(encode), or None."""
    encodes = window_encodes(record)
    if encodes is None:
        return None
    return sum(value(e) for e in encodes) / len(encodes)


# ------------------------------------------------- the profiler's clock

def clock_offsets(encodes: list[dict], events) -> list[tuple[float, float]]:
    """Per encode, (offset, slack) in seconds: profiler time = recorder time
    (perf_counter) + offset. `events` are the [(start, end)] seconds of the
    profiler's `encode` events, in order, one per exported encode. The
    offset is the midpoint of the start's and the end's offsets, and the
    slack half their difference (the mirror's own entry and exit): the
    profiler's clock is known to within it."""
    out = []
    for enc, (ps, pe) in zip(encodes, events):
        t0 = enc["t0_ns"] / 1e9
        o_s, o_e = ps - t0, pe - (t0 + enc["spans"][0]["end_s"])
        out.append(((o_s + o_e) / 2, abs(o_e - o_s) / 2))
    return out


def offset_spread_ms(offsets) -> float:
    values = [o for o, _ in offsets]
    return (max(values) - min(values)) * 1e3 if values else 0.0


def main_spans(enc: dict, offset: float) -> list[tuple[str, int, float, float]]:
    """The encode's main-thread spans on the profiler's clock: [(label,
    depth, start, end)], the root at depth 0. A label keeps the stage (or
    `chain`, for what lies in no stage) as its first part and the span's
    own name as its second."""
    spans = enc["spans"]
    t0 = enc["t0_ns"] / 1e9 + offset
    main = spans[0]["thread"]
    depth, top, out = {0: 0}, {0: None}, []
    for i, s in enumerate(spans):
        if s["thread"] != main or s["end_s"] is None:
            continue
        if i:
            p = s["parent"]
            depth[i] = depth[p] + 1
            top[i] = s["name"] if p == 0 else top[p]
        stage = top[i] if top[i] in STAGES else "chain"
        if i == 0:
            label = "chain/unspanned"
        elif top[i] == s["name"] and stage != "chain":
            label = stage
        else:
            label = f"{stage}/{s['name']}"
        out.append((label[:LABEL_MAX], depth[i], t0 + s["start_s"], t0 + s["end_s"]))
    return out


def deepest(spans) -> list[tuple[str, float, float]]:
    """Cut the time the spans cover into pieces, each labelled by the
    deepest span open over it: [(label, start, end)], in order."""
    marks = sorted({t for _, _, s, e in spans for t in (s, e)})
    out = []
    for a, b in zip(marks, marks[1:]):
        open_ = [(d, label) for label, d, s, e in spans if s <= a and e >= b]
        if open_:
            out.append((max(open_)[1], a, b))
    return out


def label_idle(idle, pieces) -> tuple[list[tuple[str, float]], dict[str, float]]:
    """Each idle interval split at the bounds of the pieces (both sorted and
    disjoint): (pieces [(label, seconds)] longest first, totals {label:
    seconds}). Idle time outside every piece is `harness`."""
    labelled, j = [], 0
    for s, e in idle:
        at = s
        while j < len(pieces) and pieces[j][2] <= at:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][1] < e:
            label, a, b = pieces[k]
            if a > at:
                labelled.append(("harness", a - at))
            hi = min(b, e)
            labelled.append((label, hi - max(a, at)))
            at = hi
            k += 1
        if at < e:
            labelled.append(("harness", e - at))
    totals = {}
    for label, sec in labelled:
        totals[label] = totals.get(label, 0.0) + sec
    labelled.sort(key=lambda t: -t[1])
    return labelled, totals


def worker_view(encodes) -> dict:
    """The worker threads' spans, means over the encodes: {name: {start_s,
    end_s (from the encode's start), attrs (the last encode's), overlap_s
    {main-thread child of `encode`: seconds the two ran at once}}}."""
    out = {}
    for enc in encodes:
        spans = enc["spans"]
        main = [s for s in spans if s["parent"] == 0 and s["thread"] == spans[0]["thread"]]
        for s in spans:
            if s["thread"] == spans[0]["thread"] or s["end_s"] is None:
                continue
            w = out.setdefault(s["name"], {"start_s": 0.0, "end_s": 0.0, "overlap_s": {}})
            w["start_s"] += s["start_s"] / len(encodes)
            w["end_s"] += s["end_s"] / len(encodes)
            w["attrs"] = s["attrs"]
            for m in main:
                both = min(s["end_s"], m["end_s"]) - max(s["start_s"], m["start_s"])
                if both > 0:
                    w["overlap_s"][m["name"]] = (w["overlap_s"].get(m["name"], 0.0)
                                                 + both / len(encodes))
    return out


def summarise(dev, windows, encode_events, encodes) -> dict:
    """The spans' view of a traced window: `dev` and `windows` as
    `devtrace.events` gives them, `encode_events` the profiler's [(start,
    end)] of the mirrored `encode` spans, `encodes` the window's exported
    encodes. -> clock_offset_spread_ms, idle_unspanned_s (device idle
    inside encodes under no main-thread span below `encode`), the idle time
    inside encodes, the top idle pieces and the totals by span label,
    spans, seconds by span name and counters per encode, and the worker
    threads' spans (`worker_view`)."""
    if not windows or len(encode_events) != len(encodes):
        return {}
    lo, hi = windows[0][0], windows[-1][1]
    busy = devtrace.union(devtrace.clip([(s, e) for _, s, e in dev], lo, hi))
    idle = devtrace.gaps(busy, lo, hi)
    offsets = clock_offsets(encodes, encode_events)
    pieces = []
    for enc, (offset, _) in zip(encodes, offsets):
        pieces += deepest(main_spans(enc, offset))
    labelled, totals = label_idle(idle, pieces)
    inside = sum(sec for label, sec in totals.items() if label != "harness")
    counters, span_s = {}, {}
    for enc in encodes:
        for k, v in enc["counters"].items():
            counters[k] = counters.get(k, 0) + v / len(encodes)
        for sp in enc["spans"]:
            span_s[sp["name"]] = span_s.get(sp["name"], 0.0) + sp["dur_s"] / len(encodes)
    return {
        "clock_offset_spread_ms": offset_spread_ms(offsets),
        "clock_slack_ms": max(s for _, s in offsets) * 1e3,
        "idle_unspanned_s": totals.get("chain/unspanned", 0.0),
        "idle_in_encodes_s": inside,
        "idle_gaps": [[label, sec] for label, sec in labelled[:devtrace.TOP]],
        "idle_by_span": dict(sorted(totals.items(), key=lambda kv: -kv[1])),
        "spans_per_encode": [len(e["spans"]) for e in encodes],
        "counters_per_encode": counters,
        "span_s": span_s,
        "workers": worker_view(encodes),
    }


# ---------------------------------------------------------------- the run

def measure(root: str, workload: str, seed: int, seconds: float, device: str = "cuda"):
    """`run.run_cell` of the cell with the trace on, the profiler's device
    items, windows and mirrored `encode` events kept as `run.py` reads them.
    -> (the run's result, `summarise` of its window)."""
    from pgrc_bench import run

    kept = {}
    real = devtrace.events

    def events(prof, prefix):
        from torch.autograd import DeviceType

        got = real(prof, prefix)
        kept["dev"], kept["windows"] = got
        kept["encode"] = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6)
                                for e in prof.events()
                                if e.name == "encode" and e.device_type == DeviceType.CPU)
        return got

    devtrace.events = events
    try:
        result = run.run_cell(root, workload, seed, seconds, True, device=device)
    finally:
        devtrace.events = real
    encodes = program_encodes(len(kept.get("windows") or ()))
    extra = {}
    if encodes is not None:
        extra = summarise(kept["dev"], kept["windows"], kept["encode"], encodes)
    return result, extra


def sync_check(root: str, workload: str, seed: int, device: str = "cuda") -> dict:
    """One encode of the cell's input, after a warm-up encode, with torch
    warning of every synchronising call: the warnings by source line beside
    the encode's counters."""
    import torch

    from pgrc_bench import run
    from pgrc_tpu_torch.archive import encoder
    from pgrc_tpu_torch.device import resolve

    spec = run.load_cell(root, workload)
    config, traffic = spec["config"], spec["traffic"]
    work = tempfile.mkdtemp(prefix="pgrc_bench_sync_")
    try:
        files = run.input_files(config, work)
        subprocess.run([sys.executable, os.path.join(HERE, "gen.py"),
                        json.dumps(run.generator_spec(config, traffic, seed, files))], check=True)
        flags = run.parse_flags(config["flags"])
        dev = resolve(device)
        cuda = dev.type == "cuda"
        encoder.encode(run.params_for(flags, files, os.path.join(work, "warm.pgtc")), device=dev)
        caught = []

        def keep(message, category, filename, lineno, file=None, line=None):
            # the innermost frame of the program: the line that synchronised,
            # also where torch's own Python code is the one that warns
            stack = traceback.extract_stack()[:-1]
            mine = [f for f in stack if f.filename.startswith(root)
                    and os.sep + "pgrc_bench" + os.sep not in f.filename]
            at = mine[-1] if mine else stack[-1]
            caught.append((str(message), f"{os.path.relpath(at.filename, root)}:{at.lineno}"))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = keep
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
            try:
                stats = encoder.encode(run.params_for(flags, files, os.path.join(work, "a.pgtc")),
                                       device=dev)
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    where = collections.Counter(at for message, at in caught if "synchroniz" in message)
    return {"warnings": sum(where.values()), "by_line": dict(where.most_common()),
            "device_syncs": stats.counters.get("device_syncs", 0),
            "h2d_copies": stats.counters.get("h2d_copies", 0),
            "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sync-check", action="store_true")
    args = ap.parse_args(argv)
    if args.sync_check:
        print("[sync] " + json.dumps(sync_check(ROOT, args.workload, args.seed, args.device)),
              flush=True)
        return 0
    result, extra = measure(ROOT, args.workload, args.seed, args.seconds, args.device)
    print("[spans] " + json.dumps(extra), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
