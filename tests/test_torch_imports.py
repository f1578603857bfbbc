"""The torch port imports without JAX and builds nothing at import time; it
imports nothing of `pgrc_tpu`, and runs a compress and a decode without
loading any of it."""
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from pgrc_tpu_torch.device import resolve
from test_roundtrip import synth_fastq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs in a fresh interpreter: this process has JAX loaded by conftest.py
CHILD = r"""
import subprocess, sys
calls = []
_Popen = subprocess.Popen
class Spy(_Popen):
    def __init__(self, args, *a, **k):
        calls.append(args)
        super().__init__(args, *a, **k)
subprocess.Popen = Spy
import pgrc_tpu_torch, pgrc_tpu_torch.cli, pgrc_tpu_torch.device, pgrc_tpu_torch.state
import pgrc_tpu_torch.archive.encoder, pgrc_tpu_torch.overlap.greedy_scs
import pgrc_tpu_torch.align.matcher, pgrc_tpu_torch.core.packed
import pgrc_tpu_torch.kernels.build, pgrc_tpu_torch.kernels.verify
import pgrc_tpu_torch.kernels.kmer_hash, pgrc_tpu_torch.kernels.sweep
import pgrc_tpu_torch.kernels.join_carry, pgrc_tpu_torch.kernels.sweep_pair_claim
import pgrc_tpu_torch.kernels.strand_rows, __graft_entry_torch__
import pgrc_tpu_torch.archive.decoder, pgrc_tpu_torch.core.analyzer
import pgrc_tpu_torch.synth
import pgrc_tpu_torch.parallel, pgrc_tpu_torch.parallel.mesh
from __graft_entry_torch__ import dryrun_multichip, dryrun_multihost, entry
from pgrc_tpu_torch.kernels import build
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not jax_mods, jax_mods
ref_mods = sorted(m for m in sys.modules if m == "pgrc_tpu" or m.startswith("pgrc_tpu."))
assert not ref_mods, ref_mods
assert not any("nvcc" in str(c) for c in calls), calls
assert build._lib is None
import torch.distributed
assert not torch.distributed.is_initialized()
print("ok")
"""


def test_port_imports_without_jax_or_nvcc():
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("name", ["cpu", "meta", "cuda"])
def test_resolve_never_falls_back(name):
    if name == "cpu":
        assert resolve(name) == torch.device("cpu")
    elif name == "meta":
        with pytest.raises(ValueError):
            resolve(name)
    elif torch.cuda.is_available():
        assert resolve(name).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve(name)


# a line that imports the JAX package: `import pgrc_tpu[.x]` or
# `from pgrc_tpu[.x] import`, and not `pgrc_tpu_torch`
REF_IMPORT = re.compile(r"^\s*(import|from)\s+pgrc_tpu(\.\w+)*(\s|,|$)")
PORT_FILES = sorted(os.path.relpath(f, ROOT) for f in
                    glob.glob(os.path.join(ROOT, "pgrc_tpu_torch", "**", "*.py"),
                              recursive=True)) + ["chip_smoke.py", "__graft_entry_torch__.py",
                                        "ab.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_line_imports_the_jax_package(path):
    """No module of the port, nor the smoke script, the port's graft entry
    or ab.py, imports `pgrc_tpu` (nor bench.py, which does)."""
    with open(os.path.join(ROOT, path)) as f:
        bad = [(i, line.rstrip()) for i, line in enumerate(f, 1)
               if REF_IMPORT.match(line) or re.match(r"^\s*import\s+bench\b", line)]
    assert not bad, bad


CHILD_CLI = r"""
import os, runpy, sys
def cli(*argv):
    sys.argv = ["pgrc_tpu_torch.cli", *argv]
    try:
        runpy.run_module("pgrc_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code in (0, None), (argv, e.code)
d, se, r1, r2 = sys.argv[1:5]
cli("--device", "cpu", "-i", se, os.path.join(d, "se.pgtc"))
cli("--device", "cpu", "-i", r1, r2, os.path.join(d, "pe.pgtc"))
cli("-d", os.path.join(d, "se.pgtc"))
cli("-d", os.path.join(d, "pe.pgtc"))
cli("-d", "-i", se, os.path.join(d, "se.pgtc"))
ref_mods = sorted(m for m in sys.modules if m == "pgrc_tpu" or m.startswith("pgrc_tpu."))
assert not ref_mods, ref_mods
assert "pgrc_tpu_torch.archive.decoder" in sys.modules
print("ok")
"""


def test_cli_compresses_and_decodes_without_the_jax_package(tmp_path):
    """`python -m pgrc_tpu_torch.cli` compresses a 3,000-read SE file and a
    PE pair on the CPU and decodes both with `-d`, in an interpreter that
    never loads a module of `pgrc_tpu`."""
    d = str(tmp_path)
    se, r1, r2 = (os.path.join(d, f) for f in ("se.fastq", "r1.fastq", "r2.fastq"))
    codes = synth_fastq(se, 3000, 100, 9000, seed=31)
    synth_fastq(r1, 1500, 100, 6000, seed=32)
    synth_fastq(r2, 1500, 100, 6000, seed=33)
    r = subprocess.run([sys.executable, "-c", CHILD_CLI, d, se, r1, r2], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]
    assert "Validated 3000 reads" in r.stdout and ": OK" in r.stdout
    with open(os.path.join(d, "se.pgtc_out"), "rb") as f:
        assert len(f.read()) == codes.size + codes.shape[0]
    for mate in (1, 2):
        assert os.path.getsize(os.path.join(d, f"pe.pgtc_out_{mate}")) == 1500 * 101
