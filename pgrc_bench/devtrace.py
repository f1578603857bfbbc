"""The profiler arithmetic of the benchmark's traced run.

Device activity is the union of the device's intervals (kernels, copies and
sets): a sum of their durations would count twice what overlapping streams
run at once. Idle time is what the union leaves of the traced window, split
at the boundaries of the encoder's stages, which are rebuilt from each
encode's start and its cumulative `stage_times`.

Times are seconds on the profiler's clock. Only `events` touches torch.
"""
from __future__ import annotations

# the device items that are not kernel launches
_NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10


def events(prof, span_prefix: str):
    """(device items, encode spans) of a finished `torch.profiler.profile`:
    [(name, start, end)] of every device kernel, copy and set, and
    [(start, end)] of the host's `record_function` spans named
    `<span_prefix><i>`, in order of i. The device's copies of those spans
    (its user annotations) are not device work and are left out."""
    from torch.autograd import DeviceType

    dev, spans = [], {}
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith(span_prefix):
            if e.device_type == DeviceType.CPU:
                spans[int(e.name[len(span_prefix):])] = (start, end)
        elif e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            dev.append((e.name, start, end))
    return dev, [spans[i] for i in sorted(spans)]


def union(intervals) -> list[tuple[float, float]]:
    """The union of [(start, end)] as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """What the sorted disjoint `busy` intervals leave of [lo, hi]."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


# the stage after which the encoder waits for its stage-7 self-match
CHAIN_AFTER = "bad"


def stage_spans(spans, stage_times) -> list[tuple[str, float, float]]:
    """[(label, start, end)] of each encode's stages, in order: stage k
    runs from the encode's start plus the stages before it. What the
    stages leave of the encode's wall is `chain`, placed after stage 5
    (`bad`), where the main thread waits for the stage-7 self-match; an
    encode without that stage has it at its end."""
    out = []
    for (s, e), times in zip(spans, stage_times):
        chain = max(0.0, (e - s) - sum(times.values()))
        at = s
        for name, sec in times.items():
            end = min(at + sec, e)
            out.append((name, at, end))
            at = end
            if name == CHAIN_AFTER and chain > 0 and at < e:
                end = min(at + chain, e)
                out.append(("chain", at, end))
                at = end
                chain = 0.0
        if at < e:
            out.append(("chain", at, e))
    return out


def idle_by_stage(idle, stages, lo: float, hi: float):
    """Split each idle interval at the stage boundaries: (pieces, totals),
    pieces [(label, seconds)] longest first, totals {label: seconds}. Idle
    time outside every encode is `harness`."""
    cover = sorted(stages, key=lambda t: t[1])
    marks, at = [], lo
    for _, s, e in cover:
        if s > at:
            marks.append((at, s))
        at = max(at, e)
    if at < hi:
        marks.append((at, hi))
    labelled = cover + [("harness", s, e) for s, e in marks]
    pieces, totals = [], {}
    for label, s, e in labelled:
        for gs, ge in clip(idle, s, e):
            pieces.append((label, ge - gs))
            totals[label] = totals.get(label, 0.0) + (ge - gs)
    pieces.sort(key=lambda t: -t[1])
    return pieces, totals


def top_ops(dev, n: int = TOP) -> list[list]:
    """The `n` device items that took most time, summed by name:
    [[name (xcount), seconds]]."""
    by = {}
    for name, s, e in dev:
        t, c = by.get(name, (0.0, 0))
        by[name] = (t + (e - s), c + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    return [[f"{name[:100]} (x{c})", t] for name, (t, c) in top]


def summarise(dev, spans, stage_times) -> dict:
    """The traced window's numbers: its length (`window_s`, from the first
    encode's start to the last one's end), the device's busy seconds in it
    (the union), the kernels' summed seconds, the top device items, the
    longest idle pieces by stage and the idle seconds of each stage."""
    if not spans:
        return {}
    lo, hi = spans[0][0], spans[-1][1]
    busy = union(clip([(s, e) for _, s, e in dev], lo, hi))
    in_window = [(n, s, e) for n, s, e in dev if e > lo and s < hi]
    kernels = [(s, e) for n, s, e in in_window if not n.startswith(_NOT_KERNELS)]
    pieces, totals = idle_by_stage(gaps(busy, lo, hi), stage_spans(spans, stage_times), lo, hi)
    return {
        "window_s": hi - lo,
        "busy_s": sum(e - s for s, e in busy),
        "kernel_s": sum(e - s for s, e in kernels),
        "device_ops": top_ops(in_window),
        "idle_gaps": [[label, sec] for label, sec in pieces[:TOP]],
        "idle_by_stage": totals,
    }
