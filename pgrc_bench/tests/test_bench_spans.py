"""The program's spans in the benchmark: the per-layer readers of spans and
counters, the profiler clock's mapping, the idle labels, and the CPU
harness's traced run reporting them."""
import json
import os

import pytest

from conftest import ROOT, make_root
from pgrc_bench import run, spans

NEW = ("stage_s.selfmatch_wait", "stage_s.selfmatch", "stage_s.selfmatch_select",
       "stage_s.pgseq_write", "stage_s.bad", "h2d_mb", "device_syncs")


def _span(name, parent, start, end, thread="MainThread", **attrs):
    return {"name": name, "parent": parent, "thread": thread, "start_s": start,
            "end_s": end, "dur_s": end - start, "attrs": attrs}


def _encode(wait, bad, h2d, syncs, t0_ns=0, selfmatch=True):
    """An exported encode of 10 s: stages, the self-match wait, the two
    worker threads' spans, counters."""
    s = [_span("encode", -1, 0.0, 10.0),
         _span("input", 0, 0.0, 1.0),
         _span("match", 0, 1.0, 4.0),
         _span("match.pass1", 2, 1.5, 3.0),
         _span("bad", 0, 4.0, 4.0 + bad),
         _span("selfmatch.wait", 0, 4.0 + bad, 4.0 + bad + wait),
         _span("order", 0, 4.0 + bad + wait, 9.5),
         _span("write_archive", 0, 9.5, 9.9)]
    if selfmatch:
        s += [_span("selfmatch", 0, 1.0, 6.0, "selfmatch"),
              _span("selfmatch.scan", 8, 1.0, 2.0, "selfmatch"),
              _span("selfmatch.select", 8, 2.0, 6.0, "selfmatch")]
    s.append(_span("pgseq.write", 0, 9.0, 9.4, "pgseq"))
    return {"t0_ns": t0_ns, "spans": s,
            "counters": {"h2d_bytes": h2d, "device_syncs": syncs}}


def _record(with_spans=True, **kw):
    encodes = []
    for i, (wait, bad) in enumerate([(2.0, 1.0), (3.0, 0.5)]):
        e = {"start_s": 10.0 * i, "end_s": 10.0 * i + 10, "bases": 2e8,
             "stage_times": {"input": 1.0, "match": 3.0, "bad": bad, "order": 1.0}}
        if with_spans:
            e.update({k: v for k, v in _encode(wait, bad, 3 << 20, 400 + i, **kw).items()
                      if k in ("spans", "counters")})
        encodes.append(e)
    return {"encodes": encodes, "trace": None}


@pytest.mark.parametrize("name,want", [
    ("stage_s.selfmatch_wait", 2.5), ("stage_s.selfmatch", 5.0),
    ("stage_s.selfmatch_select", 4.0), ("stage_s.pgseq_write", 0.4), ("stage_s.bad", 0.75),
    ("h2d_mb", 3.0), ("device_syncs", 400.5),
])
def test_reader_with_spans(name, want):
    assert run.load_reader(ROOT, name)(_record()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_spans_reads_none(name):
    """Records without spans or counters, which no encode of this process's
    recorder matches (a parent program's run), read None."""
    assert run.load_reader(ROOT, name)(_record(with_spans=False)) is None


@pytest.mark.parametrize("name,want", [("stage_s.selfmatch", 0.0),
                                       ("stage_s.selfmatch_select", 0.0)])
def test_reader_of_a_span_that_never_opened_reads_zero(name, want):
    assert run.load_reader(ROOT, name)(_record(selfmatch=False)) == want


def test_records_match_the_program_encodes_by_stage_times(tmp_path):
    """Without spans on the record, the readers take this process's last
    encodes from the program's recorder, where each record's stage_times
    are its encode's stage spans."""
    import torch

    from pgrc_tpu_torch.archive import encoder
    from pgrc_tpu_torch.config import PgRCParams
    from pgrc_tpu_torch.synth import synth_fastq

    work = str(tmp_path)
    src = os.path.join(work, "in.fastq")
    synth_fastq(src, 1200, 100, 3000, seed=4)
    stats = [encoder.encode(PgRCParams(src_fastq=src, output=os.path.join(work, f"s{i}.pgtc")),
                            device=torch.device("cpu")) for i in range(2)]
    record = {"encodes": [{"stage_times": dict(s.stage_times)} for s in stats]}
    got = spans.window_encodes(record)
    assert [g["spans"] for g in got] == [s.spans for s in stats]
    assert run.load_reader(ROOT, "stage_s.bad")(record) == pytest.approx(
        sum(s.stage_times["bad"] for s in stats) / 2)
    record["encodes"].reverse()
    assert spans.window_encodes(record) is None


def test_clock_offsets_and_labels_on_a_synthetic_trace():
    """Two encodes on a profiler clock 100 s ahead of the recorder's (the
    second 0.5 ms further): the offsets, their spread, the idle pieces
    labelled by the deepest main-thread span, and the unspanned idle."""
    encs = [_encode(2.0, 1.0, 0, 0, t0_ns=0), _encode(2.0, 1.0, 0, 0, t0_ns=20 * 10**9)]
    events = [(100.0, 110.0), (120.0005, 130.0005)]
    offsets = spans.clock_offsets(encs, events)
    assert [o for o, _ in offsets] == pytest.approx([100.0, 100.0005])
    assert all(s == pytest.approx(0.0, abs=1e-9) for _, s in offsets)
    assert spans.offset_spread_ms(offsets) == pytest.approx(0.5)
    windows = [(100.0, 110.0), (120.0005, 130.0005)]
    dev = [("k", 101.2, 101.6), ("k", 109.95, 110.0), ("k", 125.0, 130.0005)]
    got = spans.summarise(dev, windows, events, encs)
    assert got["clock_offset_spread_ms"] == pytest.approx(0.5)
    by = got["idle_by_span"]
    assert by["input"] == pytest.approx(1.0 + 1.0)
    assert by["match"] == pytest.approx(0.2 + 1.0 + 0.5 + 1.0)
    assert by["match/match.pass1"] == pytest.approx(1.4 + 1.5)
    assert by["bad"] == pytest.approx(1.0 + 0.9995)
    assert by["chain/selfmatch.wait"] == pytest.approx(2.0)
    assert by["order"] == pytest.approx(2.5)
    assert by["chain/write_archive"] == pytest.approx(0.4)
    assert by["harness"] == pytest.approx(10.0005)
    assert got["idle_unspanned_s"] == pytest.approx(0.05)
    assert got["idle_in_encodes_s"] == pytest.approx(10.0 - 0.45 + 5.0 - 0.0005)
    assert got["idle_gaps"][0] == ["harness", pytest.approx(10.0005)]
    assert all(len(label) <= 64 and "/" in label or label in spans.STAGES or label == "harness"
               for label in by)
    assert got["spans_per_encode"] == [12, 12]
    assert got["span_s"]["selfmatch.wait"] == pytest.approx(2.0)
    select = got["workers"]["selfmatch.select"]
    assert (select["start_s"], select["end_s"]) == pytest.approx((2.0, 6.0))
    assert select["overlap_s"] == pytest.approx({"match": 2.0, "bad": 1.0,
                                                 "selfmatch.wait": 1.0})


def test_traced_cpu_run_reports_the_span_metrics(tmp_path):
    """The CPU harness's traced small cell, with the new metrics listing it,
    reports all seven; the spans' run adds the clock offsets' spread and
    the unspanned idle."""
    root = str(tmp_path)
    bench = make_root(root)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("tiny_se.lq12")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r, extra = spans.measure(root, "tiny_se.lq12", 2**31 + 9, 0, device="cpu")
    assert r["correct"]
    assert set(NEW) <= set(r["metrics"])
    assert r["metrics"]["stage_s.selfmatch"]["value"] > 0
    assert r["metrics"]["h2d_mb"]["value"] == 0     # no card: nothing crosses
    assert extra["clock_offset_spread_ms"] == 0.0 and extra["clock_slack_ms"] < 1
    assert 0 <= extra["idle_unspanned_s"] <= 0.02 * extra["idle_in_encodes_s"]
    assert 0 < extra["spans_per_encode"][0] <= 300


def test_sync_check_runs_on_the_cpu(tiny_root):
    """The sync check's encode on the CPU: no card, so no warning and no
    counted read; its fields are there for the card's run."""
    got = spans.sync_check(tiny_root, "tiny_se.lq12", 3, device="cpu")
    assert got == {"warnings": 0, "by_line": {}, "device_syncs": 0, "h2d_copies": 0,
                   "device": "cpu"}
