"""The port's validation and its `-E` chain, where the port repairs faults of
the reference's (ROADMAP R1-R3): validate must fail a source with a byte
swapped between two reads in the same column, or with its PE mates
re-matched between pairs, and must pass every good archive; `-E 6` is
refused before anything is written. The reference's validate passes the
first two (its line hashes and pair fingerprint are linear), so these tests
hold the port alone."""
import os

import numpy as np
import pytest

from pgrc_tpu_torch import cli
from pgrc_tpu_torch.archive import decoder
from test_roundtrip import synth_fastq


def seq_lines(path):
    with open(path, "rb") as f:
        return f.read().split(b"\n")


def write_lines(path, lines):
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """A source pair and its archives in every mode, through the port's CLI
    on the CPU."""
    d = str(tmp_path_factory.mktemp("validate"))
    src = [os.path.join(d, f"r{i}.fastq") for i in (1, 2)]
    synth_fastq(src[0], 400, 80, 3000, seed=41)
    synth_fastq(src[1], 400, 80, 3000, seed=42)
    out = {}
    for mode, argv, files in (("SE", [], src[:1]), ("PE", [], src), ("MIN_PE", ["-s"], src),
                              ("SE_ORD", ["-o"], src[:1]), ("PE_ORD", ["-o"], src),
                              ("S", ["-S"], src)):
        out[mode] = (os.path.join(d, f"{mode}.pgtc"), files)
        assert cli.main(["--device", "cpu", *argv, "-i", *files, out[mode][0]]) == 0
    return d, src, out


@pytest.mark.parametrize("mode", ["SE", "PE", "MIN_PE", "SE_ORD", "PE_ORD", "S"])
def test_good_archive_validates(archives, mode):
    _, _, out = archives
    path, files = out[mode]
    rep = decoder.validate(path, *files)
    assert rep["errors"] == 0 and rep["reads"] == 400 * len(files)


@pytest.mark.parametrize("mode", ["SE", "PE"])
def test_same_column_byte_swap_fails_validate(archives, mode):
    """Two reads of the first file trade the bytes of one column: the
    multiset of reads changes, the sum of linear line hashes does not."""
    d, src, out = archives
    path, files = out[mode]
    lines = seq_lines(files[0])
    seqs = lines[1::4]
    a, b = 1, 2
    col = next(c for c in range(len(seqs[a])) if seqs[a][c] != seqs[b][c])
    sa, sb = bytearray(seqs[a]), bytearray(seqs[b])
    sa[col], sb[col] = seqs[b][col], seqs[a][col]
    assert sorted([bytes(sa), bytes(sb)]) != sorted([seqs[a], seqs[b]])
    lines[4 * a + 1], lines[4 * b + 1] = bytes(sa), bytes(sb)
    bad = os.path.join(d, f"swap_{mode}.fastq")
    write_lines(bad, lines)
    assert decoder.validate(path, bad, *files[1:])["errors"] > 0


@pytest.mark.parametrize("mode", ["PE", "MIN_PE"])
def test_rematched_pairs_fail_validate(archives, mode):
    """The second file's records rotated by one: every read is still there,
    in its file, but each mate is paired with another read."""
    d, src, out = archives
    path, files = out[mode]
    lines = seq_lines(files[1])
    recs = [lines[i:i + 4] for i in range(0, len(lines) - 1, 4)]
    rot = recs[1:] + recs[:1]
    bad = os.path.join(d, f"rematched_{mode}.fastq")
    write_lines(bad, [x for r in rot for x in r] + [b""])
    assert np.array_equal(sorted(seq_lines(bad)[1::4]), sorted(lines[1::4]))
    assert decoder.validate(path, files[0], bad)["errors"] > 0


def test_end_stage_6_is_refused_before_any_write(archives, tmp_path):
    """-E 6 would write an archive without its pg streams: it is refused,
    and nothing appears at the output path or beside it."""
    _, src, _ = archives
    out = str(tmp_path / "e6.pgtc")
    with pytest.raises(ValueError, match="-E 6"):
        cli.main(["--device", "cpu", "-E", "6", "-i", src[0], out])
    assert os.listdir(tmp_path) == []
