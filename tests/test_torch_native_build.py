"""The native library's build: four processes that find it missing at once
all load a whole library (one builds it under the lock, into a file of its
own; the others wait and find it built), and a build that fails raises in
every wrapper."""
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

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


U8, I32, I64 = np.uint8, np.int32, np.int64
FASTQ = b"@r\nACGT\n+\nIIII\n"
# every wrapper of the library, called on input it accepts
WRAPPERS = {
    "get_lib": lambda: native.get_lib(),
    "fastq_parse": lambda: native.fastq_parse(FASTQ),
    "fastq_parse_div_into": lambda: native.fastq_parse_div_into(
        FASTQ, 4, 2, True, np.zeros((2, 4), U8), np.zeros(2, U8), np.zeros(2, U8), 0),
    "lines_parse": lambda: native.lines_parse(b"ACGT\n"),
    "reconstruct_lines": lambda: native.reconstruct_lines(np.zeros(8, U8),
                                                          np.zeros(1, I64), 4),
    "rc_encode": lambda: native.rc_encode(b"abc", 0, 1, 256),
    "rc_decode": lambda: native.rc_decode(bytes(8), 3, 0, 1, 256),
    "rcx_encode": lambda: native.rcx_encode(b"abc", 256, 1),
    "rcx_decode": lambda: native.rcx_decode(bytes(8), 3, 256, 1),
    "rans_encode": lambda: native.rans_encode(b"abc"),
    "rans_decode": lambda: native.rans_decode(bytes(8), 3),
    "pair_walk_decode": lambda: native.pair_walk_decode(np.ones(1, I64)),
    "chain_walk_assemble": lambda: native.chain_walk_assemble(
        np.full(2, -1, I32), np.zeros(2, I32), np.zeros((2, 4), U8)),
    "extract_mismatches": lambda: native.extract_mismatches(
        np.zeros(8, U8), np.zeros(1, I64), np.zeros(1, U8), np.zeros((1, 4), U8), 2),
    "pack_lanes": lambda: native.pack_lanes(np.zeros((1, 4), U8),
                                            np.zeros((1, 2), np.uint32), None),
    "reads_write_lines": lambda: native.reads_write_lines(np.zeros((1, 4), U8)),
    "pg_index": lambda: native.pg_index(np.zeros(64, U8), 24, 7),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_a_failed_build_raises_in_every_wrapper(tmp_path, monkeypatch, name):
    """With no library loaded and a source g++ refuses, every wrapper
    raises RuntimeError with g++'s message, and none returns None: the
    library is required, as the CUDA kernel library is."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("#error the build is forced to fail\n")
    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "libpgrc_native.so"))
    monkeypatch.setattr(native, "_SOURCES", [str(bad)])
    with pytest.raises(RuntimeError, match="the build is forced to fail"):
        WRAPPERS[name]()
    assert native._lib_handle is None and not (tmp_path / "libpgrc_native.so").exists()
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_a_failed_build_is_not_reported_as_a_corrupt_archive(tmp_path, monkeypatch):
    """A good archive whose decode finds the library unbuildable raises the
    build's RuntimeError, not PgtcFormatError: a broken toolchain is not a
    corrupt archive."""
    from pgrc_tpu_torch import cli, synth
    from pgrc_tpu_torch.archive import decoder
    from pgrc_tpu_torch.utils.errors import PgtcFormatError

    src, archive = str(tmp_path / "in.fastq"), str(tmp_path / "a.pgtc")
    synth.synth_fastq(src, 2000, 100, 6000, seed=3)
    assert cli.main(["--device", "cpu", "-i", src, archive]) == 0
    bad = tmp_path / "bad.cpp"
    bad.write_text("#error the build is forced to fail\n")
    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "libpgrc_native.so"))
    monkeypatch.setattr(native, "_SOURCES", [str(bad)])
    with pytest.raises(RuntimeError, match="the build is forced to fail") as got:
        decoder.decode_to_files(archive, str(tmp_path / "dec"))
    assert not isinstance(got.value, PgtcFormatError)
