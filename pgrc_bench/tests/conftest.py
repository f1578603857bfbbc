"""Tests of the benchmark harness: `python -m pytest pgrc_bench/tests -q`.

Tests marked `card` need an NVIDIA card and skip elsewhere (their fixture
decides, when the test runs); on the card:
`python -m pytest pgrc_bench/tests -q -m card`.
"""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"reads": 6000, "genome_len": 15000}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def make_root(path, extra_configs=()):
    """A benchmark root at `path`: the repo's BENCHMARK.json and data files,
    plus `tiny_se` and `tiny_pe`, the two configurations at 6,000 reads of
    a 15,000-base genome, and their cells `tiny_se.lq12`, `tiny_pe.lq12`."""
    bench_dir = os.path.join(path, "pgrc_bench")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "pgrc_bench", sub), os.path.join(bench_dir, sub))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, base in (("tiny_se", "se100_human"), ("tiny_pe", "pe100_human")):
        with open(os.path.join(bench_dir, "configs", base + ".json")) as f:
            cfg = json.load(f)
        cfg.update(TINY)
        with open(os.path.join(bench_dir, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"pgrc_bench/configs/{name}.json",
                                 "reduced": cfg["reduced"], "why": "a test's tiny configuration"})
        bench["workloads"].append({"name": f"{name}.lq12", "config": name, "traffic": "lq12",
                                   "chips": 1, "why": "a test's tiny cell"})
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench_root"))
    make_root(path)
    return path
