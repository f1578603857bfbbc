"""The port's span and counter recorder.

Every encode (`archive.encoder.encode`) is one recorder, opened by
`record("encode")`: in memory and always, it holds a span for each stage
and sub-stage, on the main thread and on the encode's worker threads (the
stage-7 self-match and the pseudogenome writer, started by `start_thread`),
and the encode's counters (host<->device bytes and device reads from
`state`, kernel launches, the stage-7 index). A span has a stable name
(sizes go in its attrs, never in the name), its recorder's encode id, its
parent, its thread's name, and its start and end on
`time.perf_counter_ns()`. The encode's spans and counters come back on its
`EncodeStats`; the last `RECENT` recorders stay readable through `recent()`.

A span costs a clock read at each end, a list append and a context
variable's set and reset; it never touches the device and formats nothing
unless printing is on. While a torch profiler records, each span also opens
`torch.profiler.record_function(name)` inside its own clock reads, so the
spans stand beside the kernels in the profiler's trace; the root span's
start and end, each beside its event's, map the recorder's clock onto the
profiler's (`pgrc_bench/spans.py`).

PGRC_TPU_TRACE=1 (or `set_printing(True)`) prints a line per span as it
ends: encode id, start as an offset from the root's, thread, path from the
root, duration and attrs:

    [trace] e3 +4.512s MainThread encode/match/match.pass1 1.234s offs=23 rows=845073

This module imports nothing of torch: the decoder's modules use it too.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import os
import sys
import threading
import time
from concurrent.futures import Future

# finished recorders kept for `recent()`
RECENT = 64

_now = time.perf_counter_ns
_printing = bool(os.environ.get("PGRC_TPU_TRACE"))
_ids = itertools.count(1)
_recent: collections.deque = collections.deque(maxlen=RECENT)
# (recorder, open span) of this context; a worker thread runs in a copy
_current = contextvars.ContextVar("pgrc_tpu_torch_trace", default=(None, None))


def set_printing(on: bool) -> bool:
    """Print a `[trace]` line per span as it ends (PGRC_TPU_TRACE=1 at import
    sets it). -> the previous setting."""
    global _printing
    was, _printing = _printing, bool(on)
    return was


class Span:
    """One span: name, attrs, parent span (None for a root), thread name,
    start and end in perf_counter nanoseconds (end None while open)."""
    __slots__ = ("name", "attrs", "parent", "thread", "start", "end")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.parent = self.end = None

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def path(self) -> str:
        names, s = [], self
        while s is not None:
            names.append(s.name)
            s = s.parent
        return "/".join(reversed(names))


class Recorder:
    """The spans (in order of their start) and counters of one root span."""

    def __init__(self):
        self.encode_id = next(_ids)
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def root(self) -> Span:
        return self.spans[0]

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def export(self) -> dict:
        """Plain data: `spans` [{name, parent (index, -1 for the root),
        thread, start_s, end_s (seconds from the root's start; end None while
        open), dur_s, attrs}] in order of start, `counters`, the root's start
        `t0_ns` on perf_counter_ns, and `encode_id`."""
        spans = list(self.spans)
        index = {id(s): i for i, s in enumerate(spans)}
        t0 = spans[0].start
        out = []
        for s in spans:
            done = s.end is not None
            out.append({"name": s.name, "parent": index.get(id(s.parent), -1),
                        "thread": s.thread, "start_s": (s.start - t0) / 1e9,
                        "end_s": (s.end - t0) / 1e9 if done else None,
                        "dur_s": s.seconds if done else None, "attrs": dict(s.attrs)})
        with self._lock:
            counters = dict(self.counters)
        return {"encode_id": self.encode_id, "t0_ns": t0, "spans": out, "counters": counters}


def _mirror(name: str):
    """record_function(name), entered, while a torch profiler records; else
    None. With no profiler this is a dict lookup and an attribute read."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


class span:
    """`with span("match.pass1", rows=n) as s:` — a span, child of this
    context's open span, recorded in its recorder (outside any recorder it
    is only timed, and printed when printing is on). `s` is the `Span`: its
    attrs may be added to before it ends, and `s.seconds` read after."""
    __slots__ = ("sp", "rec", "_root", "_token", "_rf")

    def __init__(self, name: str, **attrs):
        self.sp = Span(name, attrs)
        self._root = False

    def __enter__(self):
        sp = self.sp
        if self._root:
            rec, parent = Recorder(), None
        else:
            rec, parent = _current.get()
        self.rec = rec
        sp.parent = parent
        sp.thread = threading.current_thread().name
        self._token = None if rec is None else _current.set((rec, sp))
        self._rf = _mirror(sp.name)
        sp.start = _now()
        if rec is not None:
            rec.spans.append(sp)
        return rec if self._root else sp

    def __exit__(self, *exc):
        sp = self.sp
        sp.end = _now()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if self._token is not None:
            _current.reset(self._token)
        if _printing:
            print(line(self.rec, sp), flush=True)
        if self._root:
            _recent.append(self.rec)
        return False


def record(name: str, **attrs) -> span:
    """`with record("encode") as rec:` — a new recorder whose root span is
    `name`, whatever is open around it; kept in `recent()` once it ends."""
    s = span(name, **attrs)
    s._root = True
    return s


def count(name: str, n: int = 1) -> None:
    """Add n to this context's recorder's counter `name` (nothing outside a
    recorder)."""
    rec = _current.get()[0]
    if rec is not None:
        rec.count(name, n)


def recent() -> list[Recorder]:
    """The last RECENT finished recorders, oldest first."""
    return list(_recent)


def start_thread(name: str, fn, *args) -> Future:
    """Run fn(*args) in a new thread named `name`, in a copy of this
    context, so its spans are children of the span open here, in this
    recorder. The start is a span `thread.start` (attr `thread`): it holds
    the caller until the new thread lets go of the GIL. -> a Future of
    fn's result."""
    fut: Future = Future()
    ctx = contextvars.copy_context()

    def run():
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(ctx.run(fn, *args))
        except BaseException as e:  # the caller's .result() raises it
            fut.set_exception(e)

    thread = threading.Thread(target=run, name=name)
    with span("thread.start", thread=name):
        thread.start()
    return fut


def line(rec: Recorder | None, sp: Span) -> str:
    """The `[trace]` line of an ended span."""
    head = (f"e{rec.encode_id} +{(sp.start - rec.root.start) / 1e9:.3f}s"
            if rec is not None else "- +0.000s")
    attrs = "".join(f" {k}={v}" for k, v in sorted(sp.attrs.items()))
    return f"[trace] {head} {sp.thread} {sp.path()} {sp.seconds:.3f}s{attrs}"
