"""The pair path's per-layer metrics, `stage_s.pair_order` and
`pair_offsets_full_share`: their readers on synthetic records, and a traced
CPU run of a tiny `pe150_human` cell reporting both, where a tiny SE cell
reports neither."""
import json
import os

import pytest

from conftest import ROOT, make_root
from pgrc_bench import run

NEW = ("stage_s.pair_order", "pair_offsets_full_share")


def _span(name, parent, start, end):
    return {"name": name, "parent": parent, "thread": "MainThread", "start_s": start,
            "end_s": end, "dur_s": end - start, "attrs": {}}


def _record(pairs=True):
    encodes = []
    for i, (dur, full) in enumerate([(1.0, 300), (1.5, 500)]):
        spans = [_span("encode", -1, 0.0, 10.0), _span("order", 0, 8.0, 9.5),
                 _span("order.order_info", 1, 8.0, 9.5)]
        counters = {"device_syncs": 300}
        if pairs:
            spans.append(_span("order.pair_order", 2, 8.0, 8.0 + dur))
            counters.update({"pair.pairs": 1000, "pair.offsets_full": full})
        encodes.append({"start_s": 10.0 * i, "end_s": 10.0 * i + 10, "bases": 3e8,
                        "spans": spans, "counters": counters})
    return {"encodes": encodes, "trace": None}


@pytest.mark.parametrize("name,want", [("stage_s.pair_order", 1.25),
                                       ("pair_offsets_full_share", 0.4)])
def test_reader_with_pair_spans(name, want):
    assert run.load_reader(ROOT, name)(_record()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_the_pair_path_reads_none(name):
    """An SE encode, or a program without the pair spans and counters (the
    parent's), has nothing to read: None, no raise."""
    assert run.load_reader(ROOT, name)(_record(pairs=False)) is None
    assert run.load_reader(ROOT, name)({"encodes": [{"stage_times": {"input": 1.0}}]}) is None


def _tiny_root(path):
    """make_root's root plus `tiny150`: pe150_human at 4,000 pairs of a
    40,000-base genome, its cell `tiny150.lq12` listed by the new metrics."""
    bench = make_root(path)
    d = os.path.join(path, "pgrc_bench", "configs")
    with open(os.path.join(d, "pe150_human.json")) as f:
        cfg = json.load(f)
    cfg.update(reads=8000, genome_len=40_000)
    with open(os.path.join(d, "tiny150.json"), "w") as f:
        json.dump(cfg, f)
    entry = next(c for c in bench["configs"] if c["name"] == "pe150_human")
    bench["configs"].append(dict(entry, name="tiny150", file="pgrc_bench/configs/tiny150.json"))
    bench["workloads"].append({"name": "tiny150.lq12", "config": "tiny150", "traffic": "lq12",
                               "chips": 1, "why": "a test's tiny cell"})
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] += ["tiny150.lq12", "tiny_se.lq12"]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def test_traced_pe150_run_reports_the_pair_metrics(tmp_path):
    root = str(tmp_path)
    _tiny_root(root)
    r = run.run_cell(root, "tiny150.lq12", 2**31 + 150, 0, True, device="cpu")
    assert r["correct"] and r["failed"] == 0
    assert r["metrics"]["stage_s.pair_order"]["value"] > 0
    assert 0 <= r["metrics"]["pair_offsets_full_share"]["value"] <= 1
    se = run.run_cell(root, "tiny_se.lq12", 2**31 + 150, 0, True, device="cpu")
    assert se["correct"] and not set(NEW) & set(se["metrics"])
