"""Whole runs of the harness at a tiny size on the CPU (the look for a card
skipped): a sound run is correct in a configuration of each of PgRC's modes,
and the control and every fault that a one-card cell of that mode can have
come out not correct."""
import pytest

from conftest import TINY_CELLS, TINY_CONFIGS
from pgrc_bench import faults, run

CELLS = ["tiny_se.lq12", "tiny_pe.lq12"]


def _guarantee(root, cell):
    return run.guarantee(run.load_cell(root, cell)["config"])


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = run.run_cell(tiny_root, cell, 2**31 + 3, 0.5, False, device="cpu")
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"encode_mbases_s", "bits_per_base", "encode_rss_mb", "setup_s"}
    assert all(c["value"] == 0 for c in r["checks"].values())
    order = ["reads_out_of_order"] if _guarantee(tiny_root, cell).in_order else []
    assert list(r["checks"]) == ["reads_differ", "archives_failed", *order]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_per_layer_metrics(tiny_root, cell):
    r = run.run_cell(tiny_root, cell, 5, 0, True, device="cpu")
    assert r["correct"]
    # no device on the CPU: the device trace's metrics find nothing to read
    assert set(r["metrics"]) == {"stage_s.ingest", "stage_s.pgdiv", "stage_rss_mb.pgdiv",
                                 "stage_s.match", "stage_rss_mb.match", "stage_s.coding",
                                 "stage_s.chain"}
    assert r["device"]["window_s"] > 0 and r["breakdown"]["idle_gaps"]


# every fault, in each cell of a mode where it can show
FAULT_CELLS = [(f, c) for f in sorted(faults.FAULTS) for c, (_, _, flags) in
               zip(TINY_CELLS, TINY_CONFIGS) if f != "reordered" or "-o" in flags]


@pytest.mark.parametrize("fault,cell", FAULT_CELLS)
def test_fault_is_not_correct(tiny_root, fault, cell):
    assert fault != "reordered" or _guarantee(tiny_root, cell).in_order
    with faults.FAULTS[fault]():
        r = run.run_cell(tiny_root, cell, 7, 0, False, device="cpu")
    assert not r["correct"] and r["failed"] == r["attempted"] == 1
    if fault == "reordered":
        # the input's multiset in another order: only the order check sees it
        assert r["checks"]["reads_differ"]["value"] == 0
        assert r["checks"]["reads_out_of_order"]["value"] > 0
    else:
        assert r["checks"]["reads_differ"]["value"] > 0


@pytest.mark.parametrize("cell", [c for c in TINY_CELLS if "_ord" not in c])
def test_reordered_changes_nothing_without_o(tiny_root, cell):
    assert not _guarantee(tiny_root, cell).in_order
    with faults.reordered():
        r = run.run_cell(tiny_root, cell, 7, 0, False, device="cpu")
    assert r["correct"] and "reads_out_of_order" not in r["checks"]
