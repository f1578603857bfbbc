"""The port's host chain without copies of code rows: the packer, the
sweep, the matcher, the chain assembler and the mismatch extractor take row
ids into one code matrix (`rows=`) and give what they give on the gathered
rows, and what `pgrc_tpu` gives; the blocked var-len DNA coder writes
`pgrc_tpu`'s bytes; the encoder's per-stage peak RSS trace."""
import re
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest
import torch

from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu.overlap import greedy_scs as ref_scs
from pgrc_tpu.streams import varlen_dna as ref_varlen
from pgrc_tpu_torch import native, synth
from pgrc_tpu_torch.align import matcher
from pgrc_tpu_torch.archive import encoder
from pgrc_tpu_torch.config import PgRCParams
from pgrc_tpu_torch.core import packed_host
from pgrc_tpu_torch.overlap import greedy_scs as port_scs
from pgrc_tpu_torch.overlap import host as overlap_host
from pgrc_tpu_torch.streams import varlen_dna
from test_align import make_pg_and_reads
from test_overlap import sample_genome_reads

L = 100


def matrix_with_ids(n_rows, seed, n_frac):
    """A code matrix of n_rows reads (N in a fraction of the rows) and ids
    into it that repeat and run out of order."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n_rows, L), dtype=np.uint8)
    with_n = np.nonzero(rng.random(n_rows) < n_frac)[0]
    codes[with_n, rng.integers(0, L, with_n.size)] = 4
    ids = rng.permutation(n_rows)[: n_rows * 2 // 3]
    ids = np.concatenate([ids, ids[:50], ids[::-7]])
    return codes, ids


def numpy_only(monkeypatch):
    monkeypatch.setattr(native, "pack_lanes", lambda *a, **k: None)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("n_frac", [0.0, 0.05])
def test_pack_lanes_by_ids_equals_gathered(monkeypatch, path, n_frac):
    """pack_lanes(codes, rows=ids) is pack_lanes(codes[ids]) and the
    reference's, lanes and N mask (None without an N), on either path."""
    if path == "numpy":
        numpy_only(monkeypatch)
    else:
        assert native.get_lib() is not None
    codes, ids = matrix_with_ids(5000, 3, n_frac)
    got = packed_host.pack_lanes(codes, rows=ids)
    for want in (packed_host.pack_lanes(codes[ids]), ref_packed.pack_lanes(codes[ids])):
        np.testing.assert_array_equal(got[0], want[0])
        if n_frac:
            np.testing.assert_array_equal(got[1], want[1])
        else:
            assert got[1] is None and want[1] is None


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_pack_lanes_pads_and_finds_an_n_in_one_row(monkeypatch, path):
    """Rows past n stay zero; one N in one row of a chunk past the first
    makes the mask."""
    if path == "numpy":
        numpy_only(monkeypatch)
    codes, ids = matrix_with_ids(70_000, 4, 0.0)
    codes[ids[-1], 17] = 4
    lanes, nmask = packed_host.pack_lanes(codes, n_pad=ids.size + 9, rows=ids)
    want_l, want_m = ref_packed.pack_lanes(codes[ids], n_pad=ids.size + 9)
    np.testing.assert_array_equal(lanes, want_l)
    np.testing.assert_array_equal(nmask, want_m)
    assert not lanes[ids.size:].any()
    np.testing.assert_array_equal(nmask[:ids.size].any(axis=1), ids == ids[-1])


def test_native_gathers_refuse_ids_out_of_range():
    """An id past the matrix raises before the native pass reads through
    it, in each native gather."""
    codes = np.zeros((10, L), dtype=np.uint8)
    lanes = np.zeros((2, 8), dtype=np.uint32)
    for rows in ([0, 10], [-1, 3]):
        with pytest.raises(IndexError):
            native.pack_lanes(codes, lanes, None, rows=np.array(rows))
        with pytest.raises(IndexError):
            native.extract_mismatches(np.zeros(300, np.uint8), np.zeros(2, np.int64),
                                      np.zeros(2, bool), codes, 5, rows=np.array(rows))
        with pytest.raises(IndexError):
            native.chain_walk_assemble(np.full(2, -1, np.int32), np.zeros(2, np.int32),
                                       codes, rows=np.array(rows))


def test_rows_with_n_by_ids():
    codes, ids = matrix_with_ids(3000, 5, 0.1)
    np.testing.assert_array_equal(packed_host.rows_with_n(codes, ids),
                                  (codes[ids] == 4).any(axis=1))
    np.testing.assert_array_equal(packed_host.rows_with_n(codes), (codes == 4).any(axis=1))


def hq_matrix(seed):
    """Genome reads at ~10x inside a matrix of other reads: (codes, hq ids
    in ascending order, as the encoder's are)."""
    hq = sample_genome_reads(2500, L, 25_000, seed=seed)
    rng = np.random.default_rng(seed)
    others = rng.integers(0, 4, size=(1500, L), dtype=np.uint8)
    order = rng.permutation(4000)
    codes = np.concatenate([hq, others])[order]
    ids = np.nonzero(order < 2500)[0]
    return codes, ids


@pytest.mark.parametrize("seed,coef", [(21, 0.65), (22, 1.0)])
def test_divide_and_generate_by_ids(monkeypatch, seed, coef):
    """divide_and_generate(codes, rows=ids) equals the call on codes[ids]
    and pgrc_tpu's (keep, pg, order, pos), through the device rounds."""
    monkeypatch.setattr(ref_scs, "_HOST_SWEEP_MAX", 0)
    monkeypatch.setattr(port_scs, "_HOST_SWEEP_MAX", 0)
    codes, ids = hq_matrix(seed)
    got = port_scs.divide_and_generate(codes, coef, device="cpu", rows=ids)
    for want in (port_scs.divide_and_generate(codes[ids], coef, device="cpu"),
                 ref_scs.divide_and_generate(codes[ids], coef)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert 0 < got[1].size < ids.size * L


def test_generate_pseudogenome_and_partitioned_sweep_by_ids(monkeypatch):
    """The stage-3 and stage-5 wrapper and the partitioned sweep (cap 1000
    rows: 3 parts and a cross-part repair) take ids as well."""
    monkeypatch.setattr(ref_scs, "_HOST_SWEEP_MAX", 0)
    monkeypatch.setattr(port_scs, "_HOST_SWEEP_MAX", 0)
    codes, ids = hq_matrix(23)
    got = port_scs.generate_pseudogenome(codes, device="cpu", rows=ids)
    for a, b in zip(got, ref_scs.generate_pseudogenome(codes[ids])):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(ref_scs, "_SWEEP_MAX_ROWS", 1000)
    monkeypatch.setattr(port_scs, "_SWEEP_MAX_ROWS", 1000)
    a = port_scs.find_overlaps(codes, 1.0, device="cpu", rows=ids)
    b = ref_scs.find_overlaps(codes[ids], 1.0)
    np.testing.assert_array_equal(a.succ, b.succ)
    np.testing.assert_array_equal(a.overlap, b.overlap)


def test_stages_2_3_hold_no_copy_of_the_rows(monkeypatch):
    """Under tracemalloc, at ~20k reads, the numpy peak of stages 2+3
    called with ids stays below half of one [n_hq, L] copy above what the
    call starts with; a gathered copy or an [n, L] bool temporary would
    pass it."""
    monkeypatch.setattr(port_scs, "_HOST_SWEEP_MAX", 0)
    n = 20_000
    hq = sample_genome_reads(n, L, 400_000, seed=24)
    codes = np.concatenate([hq, np.zeros((2000, L), dtype=np.uint8)])
    ids = np.arange(n, dtype=np.int64)
    port_scs.divide_and_generate(codes, 0.65, device="cpu", rows=ids)   # warm caches
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        start = tracemalloc.get_traced_memory()[0]
        keep, pg, _, _ = port_scs.divide_and_generate(codes, 0.65, device="cpu", rows=ids)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert keep.sum() > n // 2 and pg.size > 0
    held = peak - start - pg.nbytes
    assert held < n * L // 2, (held, n * L)


def match_input():
    """Candidates with N among them and reads only the rescue finds,
    embedded out of order in a larger matrix."""
    pg, mis_reads, *_ = make_pg_and_reads(400, L, 15_000, 3, seed=2)
    mis_reads[::9, 40] = 4
    rng = np.random.default_rng(7)
    starts = rng.integers(0, pg.size - L, size=120)
    burst = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    hit = np.arange(1, L, 25)
    burst[:, hit] = (burst[:, hit] + 1) % 4
    cands = np.concatenate([mis_reads, burst, rng.integers(0, 4, (40, L), dtype=np.uint8)])
    order = rng.permutation(cands.shape[0] + 300)
    codes = np.concatenate([cands, rng.integers(0, 5, (300, L), dtype=np.uint8)])[order]
    ids = np.argsort(order)[: cands.shape[0]]
    return pg, codes, ids


def test_match_reads_by_ids(monkeypatch):
    """match_reads(codes, rows=ids) equals match_reads(codes[ids]), with N
    reads among the candidates and the rescue pass reached."""
    pg, codes, ids = match_input()
    rescued = []
    real = matcher._interleaved_rescue

    def spy(read_codes, *a, **k):
        rescued.append(read_codes.shape[0])
        return real(read_codes, *a, **k)

    monkeypatch.setattr(matcher, "_interleaved_rescue", spy)
    index = matcher.build_index(pg, k=24, device_sort=True)
    got = matcher.match_reads(codes, index, pg, max_mismatches=20, device="cpu", rows=ids)
    want = matcher.match_reads(codes[ids], index, pg, max_mismatches=20, device="cpu")
    for a, b in ((got.pos, want.pos), (got.rc, want.rc), (got.mis, want.mis)):
        np.testing.assert_array_equal(a, b)
    assert rescued and rescued[0] >= 16 and (got.mis != 255).sum() > 400
    assert (codes[ids] == 4).any(axis=1).sum() > 20


@pytest.mark.parametrize("flip_odd", [False, True])
def test_extract_mismatches_by_ids(flip_odd):
    """The native extractor reading rows through ids (and flipping the odd
    ids of a -r matrix) equals it on the gathered, flipped rows."""
    pg, codes, ids = match_input()
    index = matcher.build_index(pg, k=24, device_sort=True)
    res = matcher.match_reads(codes, index, pg, max_mismatches=20, device="cpu", rows=ids)
    m = res.pos >= 0
    org, pos, rc = ids[m], res.pos[m], res.rc[m]
    target = codes[org]
    if flip_odd:
        odd = (org & 1) == 1
        target[odd] = packed_host.revcomp_codes_matrix(target[odd])
    got = native.extract_mismatches(pg, pos, rc, codes, L, rows=org, flip_odd=flip_odd)
    want = native.extract_mismatches(pg, pos, rc, target, L)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].sum() > 0


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_layout_verify_and_assemble_by_ids(monkeypatch, path):
    """The link check and the chain walk read the rows through ids: the
    same cut links and the same pg, order and pos as on the gathered rows,
    natively and through the numpy fallback."""
    if path == "numpy":
        monkeypatch.setattr(native, "chain_walk_assemble", lambda *a, **k: None)
    codes, ids = hq_matrix(25)
    res = ref_scs.find_overlaps(codes[ids], 1.0)
    bad = np.nonzero(res.succ >= 0)[0][::17]
    res.overlap[bad] = np.maximum(res.overlap[bad] - 3, 1)   # links the check cuts
    a = overlap_host.OverlapResult(res.succ.copy(), res.overlap.copy(), L)
    b = overlap_host.OverlapResult(res.succ.copy(), res.overlap.copy(), L)
    overlap_host._verify_links(a, codes, ids)
    overlap_host._verify_links(b, codes[ids])
    np.testing.assert_array_equal(a.succ, b.succ)
    assert (a.succ != res.succ).sum() > 0
    got = overlap_host._layout_and_assemble(a, codes, ids)
    want = overlap_host._layout_and_assemble(b, codes[ids])
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def pg_stream(n, seed):
    """Value codes 0..5 as a pg stream carries them: runs of ACGT, a few N
    and match marks."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 4, n, dtype=np.uint8)
    v[rng.random(n) < 0.01] = 4
    v[rng.random(n) < 0.01] = 5
    return v.tobytes()


@pytest.mark.parametrize("codebook", varlen_dna.CODEBOOK_IDS)
@pytest.mark.parametrize("block", [1, 2, 5, 64, 4093])
def test_varlen_encode_across_block_edges(monkeypatch, codebook, block):
    """The blocked coder writes pgrc_tpu's bytes whatever the block: the
    parse crosses every block edge, from blocks shorter than a token up."""
    monkeypatch.setattr(varlen_dna, "_BLOCK", block)
    for n in (1, 4, 5, 6, block, block + 1, 3 * block + 2, 20_011):
        data = pg_stream(n, n + codebook)
        got = varlen_dna.encode(data, codebook)
        assert got == ref_varlen.encode(data, codebook), n
        assert varlen_dna.decode(got, n, codebook) == data


def test_varlen_encode_past_2_24_symbols():
    """A pg past 2^24 symbols, made by repeating a block: pgrc_tpu's bytes."""
    data = pg_stream(1 << 16, 26) * 256 + pg_stream(12_345, 27)
    assert len(data) > 1 << 24
    got = varlen_dna.encode(data, 2)
    assert got == ref_varlen.encode(data, 2)


RSS_LINE = re.compile(r"^\[rss\] (\w+): peak ([\d.]+) MB, at its end ([\d.]+) MB$")


def test_rss_trace_prints_each_stage_once(tmp_path, monkeypatch, capsys):
    """PGRC_TPU_RSS_TRACE=1: one line a stage, each stage's own peak, none
    below the resident size at that stage's end; the same figures in
    `stage_rss_mb`, and none without the variable."""
    src = str(tmp_path / "in.fastq")
    synth.synth_fastq(src, 3000, L, 8000, seed=5)
    monkeypatch.setenv("PGRC_TPU_RSS_TRACE", "1")
    stats = encoder.encode(PgRCParams(src_fastq=src, output=str(tmp_path / "a.pgtc")),
                           device=torch.device("cpu"))
    got = [RSS_LINE.match(s) for s in capsys.readouterr().out.splitlines()
           if s.startswith("[rss]")]
    assert all(got) and [m[1] for m in got] == list(stats.stage_times)
    assert {m[1]: float(m[2]) for m in got} == stats.stage_rss_mb
    assert all(float(m[2]) >= float(m[3]) > 0 for m in got)
    monkeypatch.delenv("PGRC_TPU_RSS_TRACE")
    stats = encoder.encode(PgRCParams(src_fastq=src, output=str(tmp_path / "b.pgtc")),
                           device=torch.device("cpu"))
    assert stats.stage_rss_mb is None and "[rss]" not in capsys.readouterr().out


def test_stage_peaks_see_a_stage_allocation():
    """StagePeaks: a 256 MB array touched and freed inside a stage shows in
    that stage's peak and not in the next one's."""
    import time

    from pgrc_tpu_torch.utils import rss

    peaks = rss.StagePeaks(every=0.005)
    try:
        before = rss.rss_now_mb()
        a = np.ones(1 << 25)
        time.sleep(0.05)
        del a
        first = peaks.take()
        second = peaks.take()
    finally:
        peaks.close()
    assert first >= before + 200 > second + 100


def test_rss_module_imports_neither_torch_nor_numpy():
    r = subprocess.run([sys.executable, "-c",
                        "import sys, pgrc_tpu_torch.utils.rss as r; r.PeakRss().mb(); "
                        "r.mapped_libraries(); "
                        "assert 'torch' not in sys.modules and 'numpy' not in sys.modules"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
