"""The port's synthetic input (`pgrc_tpu_torch.synth`, bench.py's generator)
on the CPU: its files are bench.py's byte for byte, the repeat genome (its
one input that no other test feeds the port) compresses to `pgrc_tpu`'s
archive through the device sweep's plain versions, and the port's decoder
and validator run without importing torch."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from pgrc_tpu.archive import encoder as ref_encoder
from pgrc_tpu.config import PgRCParams as RefParams
from pgrc_tpu.overlap import greedy_scs as ref_scs
from pgrc_tpu_torch import synth
from pgrc_tpu_torch.archive import decoder, encoder
from pgrc_tpu_torch.config import PgRCParams
from pgrc_tpu_torch.overlap import greedy_scs as port_scs
from pgrc_tpu_torch.utils import dna

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,pair,repeats", [(7, True, False), (11, False, True)])
def test_synth_writes_bench_files(tmp_path, seed, pair, repeats):
    """bench.py's generator and the port's copy write the same bytes (seed 7
    with its pair file, seed 11 on the repeat genome) on bench.py's genome
    length for the read count."""
    n = 3000
    genome = max(n * 100 // 40, 200_000)
    files = {}
    for name, fn in (("bench", bench.synth_fastq), ("port", synth.synth_fastq)):
        src = str(tmp_path / f"{name}.fastq")
        mate = str(tmp_path / f"{name}_2.fastq") if pair else None
        codes = fn(src, n, 100, genome, seed=seed, pair=mate, repeats=repeats)
        files[name] = [Path(p).read_bytes() for p in (src, mate) if p] + [codes]
    for a, b in zip(files["bench"], files["port"]):
        if isinstance(a, bytes):
            assert a == b and len(a) > n * 200
        else:
            np.testing.assert_array_equal(a, b)


def test_repeat_genome_archive_equals_reference(tmp_path, monkeypatch):
    """The repeat genome (diverged ALU- and LINE-like copies, tandem
    repeats) at ~40x: the port's SE archive on the CPU is `pgrc_tpu`'s byte
    for byte, with the same matched count, and decodes to the input reads.
    Both packages take their device sweep (_HOST_SWEEP_MAX = 0), so the
    port's sweep kernels run as their plain versions."""
    monkeypatch.setattr(ref_scs, "_HOST_SWEEP_MAX", 0)
    monkeypatch.setattr(port_scs, "_HOST_SWEEP_MAX", 0)
    src = str(tmp_path / "rep.fastq")
    codes = synth.synth_fastq(src, 6000, 100, 15_000, seed=11, repeats=True)
    ref_out, port_out = str(tmp_path / "ref.pgtc"), str(tmp_path / "port.pgtc")
    ref_stats = ref_encoder.encode(RefParams(src_fastq=src, output=ref_out))
    port_stats = encoder.encode(PgRCParams(src_fastq=src, output=port_out),
                                device=torch.device("cpu"))
    with open(ref_out, "rb") as a, open(port_out, "rb") as b:
        assert a.read() == b.read()
    assert port_stats.matched_count == ref_stats.matched_count > 0
    assert port_stats.hq_count == ref_stats.hq_count
    n = decoder.decode_to_files(port_out, str(tmp_path / "dec"))
    raw = np.fromfile(str(tmp_path / "dec_out"), dtype=np.uint8)
    got = dna.SYM2VAL[raw.reshape(-1, 101)[:, :100]]
    assert n == codes.shape[0] and decoder._multiset_equal(got, codes)


VALIDATE_CHILD = r"""
import sys
from pgrc_tpu_torch.archive import decoder
rep = decoder.validate(sys.argv[1], sys.argv[2])
n = decoder.decode_to_files(sys.argv[1], sys.argv[1] + ".dec")
assert rep["errors"] == 0 and rep["reads"] == n == 1500, (rep, n)
assert "torch" not in sys.modules, "the decoder imported torch"
print("ok")
"""


def test_validate_and_decode_never_import_torch(tmp_path):
    """The port's decoder and validator (host code) run without importing
    torch, so a decode or a validate holds none of its libraries."""
    src, out = str(tmp_path / "in.fastq"), str(tmp_path / "a.pgtc")
    synth.synth_fastq(src, 1500, 100, 4000, seed=3)
    encoder.encode(PgRCParams(src_fastq=src, output=out), device=torch.device("cpu"))
    r = subprocess.run([sys.executable, "-c", VALIDATE_CHILD, out, src], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
