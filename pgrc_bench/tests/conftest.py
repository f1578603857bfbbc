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


# the tiny configurations: (name, the configuration they copy, its flags),
# one for each guarantee of PgRC's modes
TINY_CONFIGS = (
    ("tiny_se", "se100_human", []),            # SE
    ("tiny_pe", "pe100_human", []),            # PE
    ("tiny_pe_min", "pe100_human", ["-s"]),    # MIN_PE: pairs without mate order
    ("tiny_pe_single", "pe100_human", ["-S"]),  # SE of both files of a pair
    ("tiny_se_ord", "se100_human", ["-o"]),    # SE_ORD: reads in input order
    ("tiny_pe_ord", "pe100_human", ["-o"]),    # PE_ORD: pairs in input order
)
TINY_CELLS = [f"{name}.lq12" for name, _, _ in TINY_CONFIGS]


def make_root(path):
    """A benchmark root at `path`: the repo's BENCHMARK.json and data files,
    plus the TINY_CONFIGS, each a configuration at 6,000 reads of a
    15,000-base genome with its flags, and a cell `<name>.lq12` of each."""
    bench_dir = os.path.join(path, "pgrc_bench")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "pgrc_bench", sub), os.path.join(bench_dir, sub))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, base, flags in TINY_CONFIGS:
        with open(os.path.join(bench_dir, "configs", base + ".json")) as f:
            cfg = json.load(f)
        cfg.update(TINY, flags=flags)
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
