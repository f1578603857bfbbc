"""The port's span and counter recorder (`pgrc_tpu_torch.utils.trace`) and
the encode it instruments, on the CPU: nesting, parents, encode ids and
thread names, `stage_times` as a view of the stage spans, the main thread's
cover of the encode, the archive's bytes under the profiler and the
printer, the spans' place in a profiler's trace, the transfer counters of
`state`'s helpers, the native fallback counter, and no string built while
printing is off."""
import collections
import re
import threading

import numpy as np
import pytest
import torch

from pgrc_tpu_torch import native, state
from pgrc_tpu_torch.archive import encoder
from pgrc_tpu_torch.config import PgRCParams
from pgrc_tpu_torch.overlap import greedy_scs
from pgrc_tpu_torch.overlap import host as overlap_host
from pgrc_tpu_torch.utils import trace, uint
from test_overlap import sample_genome_reads
from test_roundtrip import synth_fastq

STAGES = ["input", "div", "pgdiv", "good", "match", "bad", "order", "pgseq"]
NAME = re.compile(r"^[a-z_]+(\.[a-z_0-9]+)*$")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    """Reads enough for every span of an encode: a self-match, a rescue,
    reads with N."""
    path = str(tmp_path_factory.mktemp("trace") / "in.fastq")
    synth_fastq(path, 6000, 100, 15000, seed=31)
    return path


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """Reads few enough for an encode under the profiler."""
    path = str(tmp_path_factory.mktemp("trace") / "small.fastq")
    synth_fastq(path, 800, 100, 2500, seed=7)
    return path


def _encode(src, out, device_sweep=True):
    """One encode of `src` on the CPU, through the device sweep (the numpy
    mirror of small inputs off) or not -> (stats, archive bytes)."""
    with pytest.MonkeyPatch.context() as mp:
        if device_sweep:
            mp.setattr(greedy_scs, "_HOST_SWEEP_MAX", 0)
        stats = encoder.encode(PgRCParams(src_fastq=src, output=out), device=CPU)
    with open(out, "rb") as f:
        return stats, f.read()


@pytest.fixture(scope="module")
def encoded(src, tmp_path_factory):
    return _encode(src, str(tmp_path_factory.mktemp("trace") / "base.pgtc"))


def _children(spans, i):
    return [s for s in spans if s["parent"] == i]


# ------------------------------------------------------------ the recorder

def test_spans_nest_under_one_recorder():
    with trace.record("root", k=1) as rec:
        with trace.span("a", rows=3) as a:
            with trace.span("a.b"):
                trace.count("x", 2)
        with trace.span("c"):
            trace.count("x")
    got = rec.export()
    names = [s["name"] for s in got["spans"]]
    assert names == ["root", "a", "a.b", "c"]
    assert [s["parent"] for s in got["spans"]] == [-1, 0, 1, 0]
    assert got["counters"] == {"x": 3} and got["encode_id"] == rec.encode_id
    assert {s["thread"] for s in got["spans"]} == {threading.current_thread().name}
    assert got["spans"][0]["start_s"] == 0 and all(
        s["end_s"] >= s["start_s"] >= 0 for s in got["spans"])
    assert got["spans"][1]["attrs"] == {"rows": 3} and a.seconds == got["spans"][1]["dur_s"]
    assert a.path() == "root/a" and trace.recent()[-1] is rec


def test_worker_thread_spans_are_children_of_the_span_open_at_its_start():
    def leaf():
        with trace.span("w"):
            return 7

    with trace.record("root") as rec:
        with trace.span("stage"):
            fut = trace.start_thread("worker", leaf)
        assert fut.result() == 7

        def work():
            with trace.span("job"):
                with trace.span("job.part"):
                    trace.count("n")
            return 5
        assert trace.start_thread("helper", work).result() == 5
    spans = rec.export()["spans"]
    by = {s["name"]: (i, s) for i, s in enumerate(spans)}
    assert spans[by["w"][0]]["parent"] == by["stage"][0] and by["w"][1]["thread"] == "worker"
    assert by["job"][1]["parent"] == 0 and by["job"][1]["thread"] == "helper"
    assert by["job.part"][1]["parent"] == by["job"][0]
    assert rec.counters == {"n": 1}


def test_worker_exception_reaches_the_caller():
    def boom():
        raise ValueError("from the worker")
    with trace.record("root"):
        fut = trace.start_thread("worker", boom)
        with pytest.raises(ValueError, match="from the worker"):
            fut.result()


def test_outside_a_recorder_spans_only_time_and_counts_drop():
    before = trace.recent()
    with trace.span("alone") as sp:
        trace.count("x")
    assert sp.seconds >= 0 and trace.recent() == before
    with trace.record("outer") as outer:
        with trace.record("inner") as inner:
            trace.count("x")
        trace.count("y")
    assert inner.counters == {"x": 1} and outer.counters == {"y": 1}
    assert inner.encode_id != outer.encode_id and len(outer.spans) == 1


def test_counts_and_spans_from_many_threads_add_up():
    """16 worker threads (more than cores) count and open spans in one
    recorder at a short switch interval: no count and no span is lost."""
    import sys

    def work():
        for _ in range(500):
            with trace.span("w"):
                trace.count("n")
                trace.count("b", 3)

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.record("root") as rec:
            futs = [trace.start_thread(f"w{i}", work) for i in range(16)]
            for f in futs:
                assert f.result(timeout=60) is None
    finally:
        sys.setswitchinterval(was)
    assert rec.counters == {"n": 16 * 500, "b": 16 * 500 * 3}
    assert sum(s.name == "w" for s in rec.spans) == 16 * 500


def test_recent_keeps_the_last_recorders():
    for i in range(trace.RECENT + 3):
        with trace.record("r", i=i):
            pass
    got = trace.recent()
    assert len(got) == trace.RECENT
    assert [r.root.attrs["i"] for r in got] == list(range(3, trace.RECENT + 3))


class Loud:
    """An attr that counts each time it is turned into a string."""
    calls = 0

    def __format__(self, spec):
        Loud.calls += 1
        return "loud"

    __str__ = __repr__ = lambda self: format(self)


def test_a_span_builds_no_string_while_printing_is_off(capsys):
    was = trace.set_printing(False)
    try:
        Loud.calls = 0
        with trace.record("root"):
            with trace.span("quiet", attr=Loud()):
                pass
        assert Loud.calls == 0 and capsys.readouterr().out == ""
        trace.set_printing(True)
        with trace.record("root"):
            with trace.span("said", attr=Loud()):
                pass
        assert Loud.calls == 1
    finally:
        trace.set_printing(was)
    lines = capsys.readouterr().out.splitlines()
    assert re.match(r"^\[trace\] e\d+ \+\d+\.\d{3}s MainThread root/said \d+\.\d{3}s attr=loud$",
                    lines[0])
    assert re.match(r"^\[trace\] e\d+ \+0\.000s MainThread root \d+\.\d{3}s$", lines[1])


# ------------------------------------------------------------ the encode

def test_stage_times_are_the_stage_spans(encoded):
    stats, _ = encoded
    assert list(stats.stage_times) == STAGES
    spans = stats.spans
    assert spans[0]["name"] == "encode" and spans[0]["parent"] == -1
    stage = {s["name"]: s for s in _children(spans, 0) if s["name"] in STAGES}
    assert list(stage) == STAGES
    assert all(stats.stage_times[k] == stage[k]["dur_s"] for k in STAGES)


def test_spans_name_their_parent_thread_and_stay_inside_it(encoded):
    stats, _ = encoded
    spans = stats.spans
    assert 40 <= len(spans) <= 300
    assert all(NAME.match(s["name"]) for s in spans)
    main = spans[0]["thread"]
    for s in spans[1:]:
        p = spans[s["parent"]]
        assert p["start_s"] <= s["start_s"] and s["end_s"] <= p["end_s"] + 1e-9
        assert s["thread"] == p["thread"] or p["name"] == "encode"
    workers = {s["name"]: s["thread"] for s in _children(spans, 0) if s["thread"] != main}
    assert workers == {"selfmatch": "selfmatch", "pgseq.write": "pgseq"}
    names = collections.Counter(s["name"] for s in spans)
    for want in ("selfmatch.wait", "selfmatch.scan", "selfmatch.select", "pgseq.match_lq_n",
                 "pgseq.code", "pgseq.wait", "write_archive", "match.host_index",
                 "match.rescue", "match.entries_merge", "sweep.rounds", "order.order_info"):
        assert names[want] >= 1, want
    assert [s["attrs"]["pg"] for s in spans if s["name"] == "bad.pg"] == ["lq", "n"]


def test_the_main_thread_covers_the_encode(encoded):
    stats, _ = encoded
    spans = stats.spans
    main = [s for s in _children(spans, 0) if s["thread"] == spans[0]["thread"]]
    assert [s["name"] for s in main] == STAGES[:4] + ["thread.start", "match", "bad",
                                                       "selfmatch.wait", "thread.start",
                                                       "order", "pgseq", "write_archive"]
    assert all(a["end_s"] <= b["start_s"] for a, b in zip(main, main[1:]))
    assert sum(s["dur_s"] for s in main) >= 0.99 * spans[0]["dur_s"]


@pytest.mark.parametrize("profiler,printing", [(True, False), (False, True), (True, True)])
def test_archive_bytes_do_not_depend_on_the_tracing(small, tmp_path, profiler, printing):
    _, want = _encode(small, str(tmp_path / "base.pgtc"), False)
    was = trace.set_printing(printing)
    try:
        if profiler:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]):
                _, got = _encode(small, str(tmp_path / "a.pgtc"), False)
        else:
            _, got = _encode(small, str(tmp_path / "a.pgtc"), False)
    finally:
        trace.set_printing(was)
    assert got == want


def test_mirrored_spans_lie_in_their_profiler_events(small, tmp_path):
    """Under a CPU torch.profiler each main-thread span of the encode is a
    `record_function` event of its name; the offset read from the root
    `encode` (the midpoint of its start and end offsets) puts every span
    inside its event, to within half the difference of those offsets."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        stats, _ = _encode(small, str(tmp_path / "p.pgtc"), False)
    spans = stats.spans
    t0 = [r for r in trace.recent() if r.root.name == "encode"][-1].root.start
    main = spans[0]["thread"]
    events = collections.defaultdict(list)
    enc = [e for e in prof.events() if e.name == "encode"]
    assert len(enc) == 1
    tid = enc[0].thread
    for e in prof.events():
        if e.thread == tid:
            events[e.name].append(e)
    for v in events.values():
        v.sort(key=lambda e: e.time_range.start)
    ev = enc[0]
    o_s = ev.time_range.start * 1e-6 - t0 * 1e-9
    o_e = ev.time_range.end * 1e-6 - (t0 * 1e-9 + spans[0]["end_s"])
    offset, slack = (o_s + o_e) / 2, abs(o_e - o_s) / 2 + 1e-6
    assert slack < 1e-3
    seen = collections.Counter()
    for s in spans:
        if s["thread"] != main:
            continue
        e = events[s["name"]][seen[s["name"]]]
        seen[s["name"]] += 1
        start = t0 * 1e-9 + s["start_s"] + offset
        end = t0 * 1e-9 + s["end_s"] + offset
        assert e.time_range.start * 1e-6 - slack <= start <= end <= e.time_range.end * 1e-6 + slack


# ------------------------------------------------------------ the counters

def _numpy_u32(n):
    return np.arange(n, dtype=np.uint32)


HELPERS = {
    "to_device": (lambda: state.to_device(np.zeros(10, np.int64), CPU), (80, 1, 0, 0)),
    "to_device.tensor": (lambda: state.to_device(torch.zeros(4, dtype=torch.int32), CPU),
                         (16, 1, 0, 0)),
    "to_host": (lambda: state.to_host(torch.zeros(6, dtype=torch.int64)), (0, 0, 48, 1)),
    "host_int": (lambda: state.host_int(torch.tensor([3])), (0, 0, 8, 1)),
    "host_ints": (lambda: state.host_ints(torch.zeros(3, dtype=torch.int64)), (0, 0, 24, 1)),
    "uint.np_u32_to_tensor": (lambda: uint.np_u32_to_tensor(_numpy_u32(5), CPU), (20, 1, 0, 0)),
    "uint.tensor_to_np_u32": (lambda: uint.tensor_to_np_u32(torch.zeros(5, dtype=torch.int32)),
                              (0, 0, 20, 1)),
    "uint.np_u64_to_tensor": (lambda: uint.np_u64_to_tensor(np.zeros(2, np.uint64), CPU),
                              (16, 1, 0, 0)),
    "uint.tensor_to_np_u64": (lambda: uint.tensor_to_np_u64(torch.zeros(2, dtype=torch.int64)),
                              (0, 0, 16, 1)),
    "match_from_device": (lambda: state.match_from_device(torch.zeros(4, dtype=torch.uint8),
                                                          torch.zeros(4, dtype=torch.int32)),
                          (0, 0, 20, 2)),
    "index_to_device": (lambda: state.index_to_device(_numpy_u32(3), np.zeros(3, np.int64), CPU),
                        (24, 2, 0, 0)),
    "pg_lanes_to_device": (lambda: state.pg_lanes_to_device(np.zeros(32, np.uint8), CPU),
                           (12, 1, 0, 0)),
}
COUNTERS = ("h2d_bytes", "h2d_copies", "d2h_bytes", "device_syncs")


@pytest.mark.parametrize("helper", sorted(HELPERS))
def test_every_transfer_helper_counts(monkeypatch, helper):
    """A spy makes every copy count as one that crosses to or from a card."""
    monkeypatch.setattr(state, "crosses", lambda src, dst: True)
    fn, want = HELPERS[helper]
    with trace.record("root") as rec:
        fn()
    assert tuple(rec.counters.get(k, 0) for k in COUNTERS) == want
    monkeypatch.undo()
    with trace.record("root") as rec:
        fn()
    assert rec.counters == {}


def test_an_encode_counts_its_transfers(src, tmp_path, monkeypatch, encoded):
    """With every copy counted (a spy), an encode reads the device at least
    once a sweep round, and uploads what its tables and reads need; on the
    CPU without the spy it counts nothing."""
    assert not any(k in encoded[0].counters for k in COUNTERS)
    monkeypatch.setattr(state, "crosses", lambda src, dst: True)
    stats, got = _encode(src, str(tmp_path / "c.pgtc"))
    assert got == encoded[1]
    c = stats.counters
    rounds = sum(s["attrs"].get("rounds", 0) for s in stats.spans if s["name"] == "sweep.rounds")
    tables = sum(s["name"] == "sweep.rounds" for s in stats.spans)
    assert rounds > 0 and c["device_syncs"] >= rounds + 2 * tables + 2
    assert c["h2d_bytes"] > 5000 * 100 // 4 and c["h2d_copies"] >= tables
    assert c["d2h_bytes"] >= 8 * rounds


def test_the_sweeps_count_their_link_checks(src, tmp_path, encoded):
    """Every device sweep table checks its links on the device (kernel J;
    its plain version here) and counts the links it checked and cut, with
    no device read of its own; the archive is the one the numpy sweep, whose
    links the host checks, writes."""
    c = encoded[0].counters
    assert 0 <= c["sweep.links_cut"] <= c["sweep.links_verified"]
    assert c["sweep.links_verified"] > 6000 // 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(greedy_scs, "_HOST_SWEEP_MAX", 10**9)
        stats, got = _encode(src, str(tmp_path / "host.pgtc"), device_sweep=False)
    assert "sweep.links_verified" not in stats.counters
    assert got == encoded[1]


def test_a_sweep_counts_the_links_it_cuts(monkeypatch):
    """A device sweep's links, some of their overlaps shortened before the
    check (as a double hash collision would leave them): the links cut are
    the host check's, and the counters count them, outside any device read."""
    codes = sample_genome_reads(4000, 100, 40_000, seed=5)
    real, seen = greedy_scs.sweep_verify_links, {}

    def shorten(lanes, nmask, L, succ, ovl, counts):
        some = torch.nonzero(succ >= 0).squeeze(1)[::9]
        ovl[some] = (ovl[some] - 2).clamp(min=1)
        seen["res"] = overlap_host.OverlapResult(succ.numpy().copy(), ovl.numpy().copy(), L)
        real(lanes, nmask, L, succ, ovl, counts)

    monkeypatch.setattr(greedy_scs, "sweep_verify_links", shorten)
    with trace.record("root") as rec:
        res = greedy_scs.find_overlaps(codes, device=CPU)
    want = seen["res"]
    checked = int((want.succ >= 0).sum())
    overlap_host._verify_links(want, codes)
    np.testing.assert_array_equal(res.succ, want.succ)
    np.testing.assert_array_equal(res.overlap, want.overlap)
    cut = checked - int((res.succ >= 0).sum())
    assert 0 < cut < checked and checked > 3000
    assert rec.counters == {"sweep.links_verified": checked, "sweep.links_cut": cut}


def test_native_fallbacks_are_counted(tmp_path, monkeypatch):
    path = str(tmp_path / "small.fastq")
    synth_fastq(path, 400, 100, 3000, seed=3)
    stats, want = _encode(path, str(tmp_path / "n.pgtc"))
    assert "native_fallbacks" not in stats.counters
    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr(native, "_lib_failed", True)
    stats, got = _encode(path, str(tmp_path / "f.pgtc"))
    assert stats.counters["native_fallbacks"] > 0
    assert got == want
