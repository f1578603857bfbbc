"""The native library's build across processes: four processes that find
it missing at once all load a whole library (one builds it under the lock,
into a file of its own; the others wait and find it built)."""
import glob
import os
import shutil
import subprocess
import sys

from pgrc_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = """
import ctypes, sys
from pgrc_tpu_torch import native
so, sources = sys.argv[1], sys.argv[2:]
assert native._build(so, sources)
lib = ctypes.CDLL(so)
print("loaded", bool(lib.rans_encode), flush=True)
"""


def test_four_processes_build_and_load_one_library(tmp_path):
    sources = []
    for src in native._SOURCES:
        sources.append(str(tmp_path / os.path.basename(src)))
        shutil.copy(src, sources[-1])
    so = str(tmp_path / "libpgrc_native.so")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, so, *sources], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [err for _, err in outs]
    assert [out.strip() for out, _ in outs] == ["loaded True"] * 4
    assert not glob.glob(str(tmp_path / "*.tmp"))
