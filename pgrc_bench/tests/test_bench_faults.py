"""Whole runs of the harness at a tiny size on the CPU (the look for a card
skipped): a sound run is correct, and the control and every fault that a
one-card cell can have come out not correct."""
import pytest

from pgrc_bench import faults, run

CELLS = ["tiny_se.lq12", "tiny_pe.lq12"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = run.run_cell(tiny_root, cell, 2**31 + 3, 0.5, False, device="cpu")
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"encode_mbases_s", "bits_per_base", "encode_rss_mb", "setup_s"}
    assert all(c["value"] == 0 for c in r["checks"].values())
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


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(tiny_root, cell, fault):
    with faults.FAULTS[fault]():
        r = run.run_cell(tiny_root, cell, 7, 0, False, device="cpu")
    assert not r["correct"] and r["failed"] == r["attempted"] == 1
    assert r["checks"]["reads_differ"]["value"] > 0
