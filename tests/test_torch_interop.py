"""tests/test_interop.py's four cases with the port's CLI on the CPU: the
reference PgRC binary and `python -m pgrc_tpu_torch.cli --device cpu` encode
the same FASTQ and decode their own archives (SE, SE_ORD, PE, PE_ORD); the
order-preserving outputs are byte-identical to the input's read lines (and
so to each other), the others equal as multisets of reads or of pairs.
Skips when the binary is absent."""
import os
import subprocess

import pytest

from pgrc_tpu_torch import cli, synth
from test_roundtrip import synth_fastq

REF_BIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "build-ref", "PgRC")

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_BIN), reason="reference PgRC binary not built"
)


def _read_lines_bytes(fastq_path: str) -> bytes:
    """The DNA lines of a FASTQ, newline-terminated (what both decoders emit)."""
    with open(fastq_path, "rb") as f:
        return b"".join(line for i, line in enumerate(f) if i % 4 == 1)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _reference(tmp_path, args, inputs, timeout=600) -> str:
    """Encode with the reference binary and decode its archive -> archive path."""
    arch = str(tmp_path / "ref.pgrc")
    subprocess.run([REF_BIN, *args, "-t", "2", "-i", *inputs, arch],
                   check=True, capture_output=True, timeout=timeout)
    subprocess.run([REF_BIN, "-t", "2", "-d", arch],
                   check=True, capture_output=True, timeout=timeout)
    return arch


def _port(tmp_path, args, inputs) -> str:
    """Encode with the port's CLI on the CPU and decode with its `-d`."""
    arch = str(tmp_path / "ours.pgtc")
    assert cli.main(["--device", "cpu", *args, "-i", *inputs, arch]) == 0
    assert cli.main(["-d", arch]) == 0
    return arch


def _pairs(out1: str, out2: str):
    return sorted(a + b"|" + b for a, b in zip(_read(out1).splitlines(),
                                               _read(out2).splitlines()))


def _synth_pair(tmp_path, n, seed):
    """Two mate files sampled near each other on one genome (bench.py's
    generator)."""
    src1, src2 = str(tmp_path / "in_1.fastq"), str(tmp_path / "in_2.fastq")
    synth.synth_fastq(src1, n, 100, max(n * 100 // 40, 20000), seed=seed, pair=src2)
    return src1, src2


def test_se_ord_outputs_byte_identical(tmp_path):
    src = str(tmp_path / "in.fastq")
    synth_fastq(src, 3000, 100, 20000, seed=11)
    want = _read_lines_bytes(src)
    ref = _reference(tmp_path, ["-o"], [src], timeout=300)
    assert _read(ref + "_out") == want, "reference round-trip must reproduce the input"
    ours = _port(tmp_path, ["-o"], [src])
    assert _read(ours + "_out") == want, "the port's ORD round-trip must reproduce the input"


def test_se_multiset_equal_to_reference_decode(tmp_path):
    src = str(tmp_path / "in.fastq")
    synth_fastq(src, 2000, 100, 15000, seed=12)
    ref = _reference(tmp_path, [], [src], timeout=300)
    ours = _port(tmp_path, [], [src])
    assert sorted(_read(ours + "_out").splitlines()) == sorted(
        _read(ref + "_out").splitlines())


def test_pe_pair_multiset_equal_to_reference_decode(tmp_path):
    """PE (not order-preserving): both tools' decoded (read1, read2) pair
    multisets equal the input's."""
    src1, src2 = _synth_pair(tmp_path, 2500, 21)
    want = sorted(a + b"|" + b for a, b in zip(_read_lines_bytes(src1).splitlines(),
                                               _read_lines_bytes(src2).splitlines()))
    ref = _reference(tmp_path, [], [src1, src2])
    assert _pairs(ref + "_out_1", ref + "_out_2") == want
    ours = _port(tmp_path, [], [src1, src2])
    assert _pairs(ours + "_out_1", ours + "_out_2") == want


def test_pe_ord_outputs_byte_identical(tmp_path):
    """PE_ORD: both tools' decoded outputs are byte-identical to both inputs."""
    src1, src2 = _synth_pair(tmp_path, 2500, 22)
    want1, want2 = _read_lines_bytes(src1), _read_lines_bytes(src2)
    ref = _reference(tmp_path, ["-o"], [src1, src2])
    assert _read(ref + "_out_1") == want1 and _read(ref + "_out_2") == want2
    ours = _port(tmp_path, ["-o"], [src1, src2])
    assert _read(ours + "_out_1") == want1 and _read(ours + "_out_2") == want2
