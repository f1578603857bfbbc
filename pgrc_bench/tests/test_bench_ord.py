"""The order-preserving path's per-layer metrics, `stage_s.order_info` and
`ord_position_bits_per_read`: their readers on synthetic records, and a
traced CPU run of a tiny SE_ORD cell reporting both, where a tiny SE cell
reports neither."""
import json
import os

import pytest

from conftest import ROOT, make_root
from pgrc_bench import run

NEW = ("stage_s.order_info", "ord_position_bits_per_read")


def _span(name, parent, start, end):
    return {"name": name, "parent": parent, "thread": "MainThread", "start_s": start,
            "end_s": end, "dur_s": end - start, "attrs": {}}


def _record(ord_path=True):
    encodes = []
    for i, (dur, stored) in enumerate([(3.0, 4_500_000), (3.5, 5_500_000)]):
        spans = [_span("encode", -1, 0.0, 10.0), _span("order", 0, 5.0, 9.5),
                 _span("order.order_info", 1, 5.0, 5.0 + dur)]
        counters = {"device_syncs": 216}
        if ord_path:
            spans += [_span("order.ord_positions", 2, 5.0, 5.1),
                      _span("order.ord_streams", 2, 5.1, 5.0 + dur)]
            counters.update({"ord.reads": 2_000_000, "ord.position_bytes": stored,
                             "ord.wide": 0})
        encodes.append({"start_s": 10.0 * i, "end_s": 10.0 * i + 10, "bases": 2e8,
                        "spans": spans, "counters": counters})
    return {"encodes": encodes, "trace": None}


@pytest.mark.parametrize("name,want", [("stage_s.order_info", 3.25),
                                       ("ord_position_bits_per_read", 20.0)])
def test_reader_with_ord_spans(name, want):
    assert run.load_reader(ROOT, name)(_record()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_the_ord_path_reads_none(name):
    """An SE, PE or MIN_PE encode, or a program without the ORD spans and
    counters (the parent's, whose `order.order_info` is there unmarked), has
    nothing to read: None, no raise."""
    assert run.load_reader(ROOT, name)(_record(ord_path=False)) is None
    assert run.load_reader(ROOT, name)({"encodes": [{"stage_times": {"input": 1.0}}]}) is None
    assert run.load_reader(ROOT, name)({"encodes": [], "trace": None}) is None


def _tiny_root(path):
    """make_root's root with the new metrics listing its tiny SE_ORD, PE_ORD
    and SE cells."""
    bench = make_root(path)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            m["workloads"] += ["tiny_se_ord.lq12", "tiny_pe_ord.lq12", "tiny_se.lq12"]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def test_traced_se_ord_run_reports_the_ord_metrics(tmp_path):
    root = str(tmp_path)
    _tiny_root(root)
    r = run.run_cell(root, "tiny_se_ord.lq12", 2**31 + 26, 0, True, device="cpu")
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["reads_out_of_order"]["value"] == 0
    assert r["metrics"]["stage_s.order_info"]["value"] > 0
    # a tiny pg: positions of ~15 bits, coded in fewer than the u32's 32
    assert 0 < r["metrics"]["ord_position_bits_per_read"]["value"] < 32
    se = run.run_cell(root, "tiny_se.lq12", 2**31 + 26, 0, True, device="cpu")
    assert se["correct"] and not set(NEW) & set(se["metrics"])


def test_traced_pe_ord_run_reports_the_ord_metrics(tmp_path):
    root = str(tmp_path)
    _tiny_root(root)
    r = run.run_cell(root, "tiny_pe_ord.lq12", 2**31 + 27, 0, True, device="cpu")
    assert r["correct"] and r["checks"]["reads_out_of_order"]["value"] == 0
    assert set(NEW) <= set(r["metrics"])
