"""The benchmark on the card: a cell's run is correct and its control is
not, at the cell's own size. Run on the chip:
`python -m pytest pgrc_bench/tests -q -m card`."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(*args):
    p = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    return [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]


@pytest.mark.card
def test_cell_is_correct_on_the_card(card):
    r = _run("pgrc_bench/run.py", "--workload", "se100_human.hq2", "--seed", "41",
             "--seconds", "1", "--trace", "0")[-1]
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["count"] == 1


@pytest.mark.card
def test_control_is_not_correct_on_the_card(card):
    for r in _run("pgrc_bench/control.py", "--workload", "se100_human.hq2", "--seeds", "42"):
        assert not r["correct"] and r["checks"]["reads_differ"]["value"] > 0
