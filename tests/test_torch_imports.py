"""The torch port imports without JAX and builds nothing at import time."""
import os
import subprocess
import sys

import pytest
import torch

from pgrc_tpu_torch.device import resolve

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
import pgrc_tpu_torch.sweep_scale
from pgrc_tpu_torch.kernels import build
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not jax_mods, jax_mods
assert not any("nvcc" in str(c) for c in calls), calls
assert build._lib is None
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
