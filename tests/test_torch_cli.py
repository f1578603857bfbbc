"""The CLI's remaining cases through the port on the CPU, each held to
`pgrc_tpu` on the same input: the analyzer (-a), the chunked decode, the
plain offset representation, and the four cases of tests/test_flags.py
(the -Q classifier, -l N with a large accept threshold, the leftover-heavy
rescue input, the interleaved rescue on a large leftover set). Archives
must be the reference's bytes; the -l and rescue archives also decode to
their input exactly."""
import dataclasses
import os
import time

import numpy as np
import pytest

from pgrc_tpu import cli as ref_cli
from pgrc_tpu.align import matcher as ref_matcher
from pgrc_tpu.archive import decoder as ref_decoder
from pgrc_tpu.archive import encoder as ref_encoder
from pgrc_tpu.config import PgRCParams as RefParams
from pgrc_tpu.core import analyzer as ref_analyzer
from pgrc_tpu.core import fastq as ref_fastq
from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu_torch import cli as port_cli
from pgrc_tpu_torch import state
from pgrc_tpu_torch.align import matcher as port_matcher
from pgrc_tpu_torch.archive import decoder as port_decoder
from pgrc_tpu_torch.archive import encoder as port_encoder
from pgrc_tpu_torch.config import PgRCParams as PortParams
from pgrc_tpu_torch.core import analyzer as port_analyzer
from pgrc_tpu_torch.core import fastq as port_fastq
from pgrc_tpu_torch.utils import dna
from test_flags import _write_fastq
from test_roundtrip import read_lines_file, synth_fastq


def encode_both(tmp_path, name, **kw):
    """One input through both encoders (the port on the CPU) with the same
    parameters; the two archives must be byte-identical. -> (reference's
    archive, port's archive, port's encode wall seconds)."""
    ref, port = (str(tmp_path / f"{name}.{who}.pgtc") for who in ("ref", "port"))
    ref_encoder.encode(RefParams(output=ref, **kw))
    t0 = time.time()
    port_encoder.encode(PortParams(output=port, **kw), device="cpu")
    wall = time.time() - t0
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert b.read() == a.read()
    return ref, port, wall


def decodes_to(archive, prefix, codes):
    n = port_decoder.decode_to_files(archive, prefix)
    return n == codes.shape[0] and port_decoder._multiset_equal(
        read_lines_file(prefix + "_out"), codes)


def test_analyzer_matches_reference(tmp_path, capsys):
    """tests/test_roundtrip.py:259's input: the port's analyze_reads_set
    gives the reference's properties, and `-a` prints its report."""
    src = str(tmp_path / "b.fastq")
    synth_fastq(src, 200, 60, 2000, seed=45)
    want = ref_analyzer.analyze_reads_set(src)
    got = port_analyzer.analyze_reads_set(src)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.count == 200 and got.total_bases == 12000 and got.constant_len
    capsys.readouterr()
    assert ref_cli.main(["-a", "-i", src, str(tmp_path / "x")]) == 0
    ref_out = capsys.readouterr().out
    assert port_cli.main(["--device", "cpu", "-a", "-i", src, str(tmp_path / "x")]) == 0
    assert capsys.readouterr().out == ref_out == want.summary() + "\n"
    assert not os.path.exists(tmp_path / "x")


@pytest.mark.parametrize("mode", ["SE", "SE_ORD", "PE", "PE_ORD"])
def test_chunked_decode_matches_reference(tmp_path, mode):
    """tests/test_roundtrip.py:213's input: the port's iter_decoded_chunks
    with 64-read chunks equals its decode_to_matrices, and both equal the
    reference's matrices."""
    p1, p2 = str(tmp_path / "c1.fastq"), str(tmp_path / "c2.fastq")
    synth_fastq(p1, 400, 80, 4000, seed=31)
    synth_fastq(p2, 400, 80, 4000, seed=32)
    kw = {"SE": {}, "SE_ORD": {"preserve_order": True}, "PE": {"pair_fastq": p2},
          "PE_ORD": {"pair_fastq": p2, "preserve_order": True}}[mode]
    ref, port, _ = encode_both(tmp_path, mode, src_fastq=p1, **kw)
    want = ref_decoder.decode_to_matrices(ref_decoder.load(ref))
    ar = port_decoder.load(port)
    whole = port_decoder.decode_to_matrices(ar)
    parts = [[] for _ in whole]
    for fi, mat in port_decoder.iter_decoded_chunks(ar, chunk=64):
        parts[fi].append(mat)
    assert len(whole) == len(want) == (2 if "PE" in mode else 1)
    assert all(len(p) > 1 for p in parts)
    for fi, w in enumerate(want):
        np.testing.assert_array_equal(whole[fi], w)
        np.testing.assert_array_equal(np.concatenate(parts[fi]), w)


def test_plain_offset_representation_matches_reference(tmp_path):
    """tests/test_roundtrip.py:244: plain mismatch offsets (no rev-offset
    coding) give the reference's archive, and it decodes exactly."""
    src = str(tmp_path / "a.fastq")
    codes = synth_fastq(src, 500, 80, 3000, seed=44)
    _, port, _ = encode_both(tmp_path, "plain", src_fastq=src, rev_offset_mismatches=False)
    assert decodes_to(port, str(tmp_path / "plain.dec"), codes)


def test_full_quality_classifier_matches_reference(tmp_path):
    """tests/test_flags.py:26's input: the -Q (full) and simplified
    classifiers and the chunked ingest's division equal the reference's on
    the same qualities, and the two modes differ where the input makes
    them."""
    rng = np.random.default_rng(5)
    n, L = 600, 80
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    qual = rng.integers(ord("#"), ord("I") + 1, size=(n, L)).astype(np.uint8)
    qual[:100] = ord("#")
    qual[:100, int(L * (1 - 0.12))] = ord("I")
    path = str(tmp_path / "q.fastq")
    _write_fastq(path, codes, qual)
    ref_reads, port_reads = ref_fastq.read_any(path), port_fastq.read_any(path)
    for simplified in (False, True):
        want = ref_fastq.quality_high_mask(ref_reads, 0.12, simplified_suffix_mode=simplified)
        got = port_fastq.quality_high_mask(port_reads, 0.12, simplified_suffix_mode=simplified)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            port_fastq.read_divided(path, None, False, 0.12, simplified).hq_mask,
            ref_fastq.read_divided(path, None, False, 0.12, simplified).hq_mask)
    full = port_fastq.quality_high_mask(port_reads, 0.12, simplified_suffix_mode=False)
    np.testing.assert_array_equal(full, (1.0 - dna.QUALITY2PROB[qual].mean(axis=1)) <= 0.12)
    assert not full[:100].any()


@pytest.mark.parametrize("accept", [3, 10])
def test_prematch_accept_matches_reference(tmp_path, accept):
    """tests/test_flags.py:62's input with `-l N` at a large accept
    threshold: the reference's archive bytes, and an exact decode."""
    path = str(tmp_path / "l.fastq")
    codes = synth_fastq(path, 1200, 80, 8000, seed=31)
    argv = ["-l", str(accept), "-i", path]
    ref, port = (str(tmp_path / f"l{accept}.{who}.pgtc") for who in ("ref", "port"))
    assert ref_cli.main([*argv, ref]) == 0
    assert port_cli.main(["--device", "cpu", *argv, port]) == 0
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert b.read() == a.read()
    assert decodes_to(port, str(tmp_path / f"l{accept}.dec"), codes)


def test_leftover_heavy_rescue_matches_reference(tmp_path):
    """tests/test_flags.py:79's input: 30% of the reads carry an error every
    11 symbols, which kills every 32-mer anchor and sends them to the
    interleaved rescue. The reference's archive bytes, an exact decode, and
    the port's encode under the reference test's 120 s."""
    rng = np.random.default_rng(7)
    n, L = 4000, 100
    genome = rng.integers(0, 4, size=40_000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - L, size=n)
    codes = genome[starts[:, None] + np.arange(L)[None, :]].copy()
    bad = rng.random(n) < 0.3
    err_cols = np.arange(3, L, 11)
    sub = codes[bad]
    sub[:, err_cols] = (sub[:, err_cols]
                        + rng.integers(1, 4, size=(sub.shape[0], err_cols.size))) % 4
    codes[bad] = sub
    qual = np.full((n, L), ord("I"), dtype=np.uint8)
    qual[rng.random(n) < 0.5, L // 2:] = ord("#")
    path = str(tmp_path / "div.fastq")
    _write_fastq(path, codes, qual)
    _, port, wall = encode_both(tmp_path, "div", src_fastq=path)
    assert wall < 120, f"leftover-heavy encode took {wall:.1f}s"
    assert decodes_to(port, str(tmp_path / "div.dec"), codes)


def test_interleaved_rescue_large_set_matches_reference():
    """tests/test_flags.py:114's input: the port's rescue (kernels K and L,
    their plain versions here) on 5000 leftover reads gives the reference's
    (mis, pos) on both strands, within the reference test's 60 s."""
    rng = np.random.default_rng(9)
    pg = rng.integers(0, 4, size=60_000).astype(np.uint8)
    n, L = 5000, 100
    starts = rng.integers(0, pg.size - L, size=n)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    err_cols = np.arange(1, L, 14)
    reads[:, err_cols] = (reads[:, err_cols] + 1) % 4
    t0 = time.time()
    mis, pos = port_matcher.rescue(reads, pg, state.pg_lanes_to_device(pg, "cpu"), 16, 2, 33)
    wall = time.time() - t0
    assert wall < 60, f"rescue of {n} reads took {wall:.1f}s"
    rc = ref_packed.revcomp_codes_matrix(reads)
    rc[rc > 3] = 0
    for strand, r in enumerate((reads, rc)):
        want_mis, want_pos = ref_matcher._interleaved_rescue(r, pg, 16, max_mis=33)
        np.testing.assert_array_equal(mis[strand], want_mis)
        np.testing.assert_array_equal(pos[strand], want_pos)
    assert (mis[0] != 255).mean() > 0.4
