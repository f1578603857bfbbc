"""The port's stage-7 pg-vs-pg scanner against `pgrc_tpu`'s, on the CPU.

The port builds one native index of a source pg (`native.PgIndex`) and
scans each query over slices of its probes on threads; `pgrc_tpu` samples
the source on every call and scans on one thread. The runs found are the
same set at every thread count, so the marks, the rewritten pgs and their
offset and length streams are the reference's bytes. The thread count is
forced here through the scan's own argument (`PgIndex.find_matches`'s
`threads`) or its probe floor (`native.SCAN_MIN_PROBES`).
"""
import time

import numpy as np
import pytest
import torch

from pgrc_tpu import native as ref_native
from pgrc_tpu.archive import pg_match as ref_pg_match
from pgrc_tpu_torch import native
from pgrc_tpu_torch.archive import encoder
from pgrc_tpu_torch.archive import pg_match
from pgrc_tpu_torch.config import PgRCParams
from pgrc_tpu_torch.utils import dna
from test_roundtrip import synth_fastq

K, K1, K2, MIN_LEN, BUCKET = 24, 7, 3, 45, 16
THREADS = (1, 2, 3, 8)


@pytest.fixture(scope="module", autouse=True)
def _libs():
    """Both packages' native libraries. `pgrc_tpu` builds its library
    without a lock, so a test process that loses a build race to another
    marks it failed: it looks again once the other has built it. The
    port's raises when it does not build."""
    for _ in range(60):
        if ref_native.get_lib() is not None:
            break
        ref_native._lib_failed = False
        time.sleep(2)
    native.get_lib()
    if ref_native.get_lib() is None:
        pytest.fail("the reference's native library does not build")


def _revcomp(a):
    return dna.COMPL_VAL[a[::-1]]


def _pg(n, seed, repeats=40, err=0.004):
    """A pg of n symbols shaped like a stage-3 one: pieces of a genome with
    planted repeats, on both strands, each with substitutions."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n, dtype=np.uint8)
    for _ in range(repeats if g.size >= 4000 else 0):
        ln = int(rng.integers(100, min(3000, g.size // 4)))
        a, b = rng.integers(0, g.size - ln, 2)
        g[b:b + ln] = g[a:a + ln]
    parts = []
    for lo in range(0, g.size, 1500):
        piece = g[lo:lo + 1500]
        for strand in (piece, _revcomp(piece))[:1 + (rng.random() < 0.6)]:
            s = strand.copy()
            hit = rng.random(s.size) < err
            s[hit] = rng.integers(0, 4, int(hit.sum()))
            parts.append(s)
    return np.concatenate(parts)[:n]


def _tandem(seed):
    """A tandem repeat of 40,000 symbols (a 13-symbol unit) inside random
    flanks: longer than a slice at any thread count here."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, 13, dtype=np.uint8)
    flank = rng.integers(0, 4, 3000, dtype=np.uint8)
    return np.concatenate([flank, np.tile(unit, 40000 // 13), _revcomp(flank)])


def _palindrome(seed):
    """A self-match palindrome: a stretch followed by its reverse
    complement, so revcomp(pg) matches pg across the fold."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 5000, dtype=np.uint8)
    s = rng.integers(0, 4, 2000, dtype=np.uint8)
    b = rng.integers(0, 4, 5000, dtype=np.uint8)
    return np.concatenate([a, s, _revcomp(s), b])


def _big_bucket(seed):
    """One 63-symbol segment 200 times, each copy after its own 70-symbol
    flank, so its k-mers lie on the sampling grid in every copy: their
    buckets hold 200 positions, far above max_bucket."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 4, 63, dtype=np.uint8)
    parts = []
    for _ in range(200):
        parts.append(rng.integers(0, 4, 70, dtype=np.uint8))
        parts.append(seg)
    return np.concatenate(parts)


def _case(name):
    """(src, query) of one case."""
    if name == "slice_edges":  # runs of 4-8k symbols cover the query
        src = _pg(120_000, 1)
        rng = np.random.default_rng(1)
        parts = []
        for _ in range(12):
            ln = int(rng.integers(4000, 8000))
            lo = int(rng.integers(0, src.size - ln))
            parts += [src[lo:lo + ln], rng.integers(0, 4, 10, dtype=np.uint8)]
        return src, np.concatenate(parts)
    if name == "tandem":
        src = _tandem(2)
        return src, src.copy()
    if name == "palindrome":
        src = _palindrome(3)
        return src, _revcomp(src)
    if name == "big_bucket":
        src = _big_bucket(4)
        return src, src.copy()
    if name == "short_src":
        return _pg(20, 5), _pg(5000, 6)
    if name == "short_query":
        return _pg(5000, 7), _pg(23, 8)
    if name == "many_runs":
        src = _pg(600_000, 9, repeats=400)
        return src, _revcomp(src)
    if name == "ragged_query":
        src = _pg(30_000, 10)
        q = _revcomp(src)[:29_998]  # (nq - k) % k2 == 1, nq % k2 == 1
        return src, q
    raise KeyError(name)


CASES = ("slice_edges", "tandem", "palindrome", "big_bucket", "short_src",
         "short_query", "many_runs", "ragged_query")


def _ref_rows(src, query):
    m = ref_native.pg_find_matches(src, query, MIN_LEN, K, K1, K2, BUCKET)
    return np.unique(m.reshape(-1, 3), axis=0)


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", CASES)
def test_scan_finds_the_reference_runs(cases, name, threads):
    src, query = cases[name]
    want = _ref_rows(src, query)
    with native.pg_index(src, K, K1) as index:
        got = index.find_matches(query, MIN_LEN, K2, BUCKET, threads)
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if name == "many_runs":
        assert want.shape[0] > 4096  # the parent's first output buffer
    if name in ("short_src", "short_query"):
        assert want.shape[0] == 0
    if name == "ragged_query":
        assert query.size % K2 and (query.size - K) % K2
    if name == "big_bucket":  # each copy's runs reach only the first 16 copies
        assert 200 < want.shape[0] < 200 * 17


def test_runs_cross_slice_edges(cases):
    """At every thread count some run spans a slice edge (so two slices
    find it), and at 8 threads the tandem repeat spans a whole slice."""
    for name in ("slice_edges", "tandem"):
        src, query = cases[name]
        runs = _ref_rows(src, query)
        q0, q1 = runs[:, 1], runs[:, 1] + runs[:, 2]
        nprobe = (query.size - K) // K2 + 1
        for t in THREADS[1:]:
            edges = np.array([nprobe * i // t * K2 for i in range(1, t)])
            assert ((q0[:, None] < edges) & (q1[:, None] > edges + K)).any()
    src, query = cases["tandem"]
    runs = _ref_rows(src, query)
    assert runs[:, 2].max() > ((query.size - K) // K2 + 1) // 8 * K2


def test_one_index_serves_every_scan(cases):
    """Scans through one index, in any order and at any thread count, find
    what a fresh index per scan finds; the index counts one build and a
    reuse per scan after its first."""
    from pgrc_tpu_torch.utils import trace

    src, _ = cases["slice_edges"]
    queries = [_revcomp(src), _revcomp(src[:50_000]), _pg(40_000, 11)]
    with trace.record("root") as rec:
        with native.pg_index(src, K, K1) as index:
            got = [index.find_matches(q, MIN_LEN, K2, BUCKET, t)
                   for q, t in zip(queries, (4, 1, 3))]
    for q, g in zip(queries, got):
        np.testing.assert_array_equal(g, _ref_rows(src, q))
    assert rec.counters == {"pgmatch.index_builds": 1, "pgmatch.index_reuses": 2}
    with pytest.raises(ValueError):
        index.find_matches(queries[0], MIN_LEN, K2, BUCKET, 1)


def test_scan_threads_follow_the_query_and_the_cpus(monkeypatch):
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: set(range(64)))
    assert native.scan_threads(0, K, K2) == 1
    assert native.scan_threads(K + 3 * native.SCAN_MIN_PROBES, K, K2) == 1
    assert native.scan_threads(K + 3 * 5 * native.SCAN_MIN_PROBES, K, K2) == 5
    assert native.scan_threads(1 << 34, K, K2) == native.SCAN_THREADS_MAX
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: {0, 1, 2})
    assert native.scan_threads(1 << 34, K, K2) == 2
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: {0})
    assert native.scan_threads(1 << 34, K, K2) == 1


# ------------------------------------------------ mark & remove, stage 7

@pytest.fixture(scope="module")
def pgs():
    """(hq, lq, n) pgs: the lq and N pgs hold pieces of revcomp(hq) among
    their own symbols; the N pg has N codes."""
    rng = np.random.default_rng(12)
    hq = _pg(200_000, 13, repeats=120)
    rc = _revcomp(hq)

    def mix(n, with_n):
        parts = []
        while sum(p.size for p in parts) < n:
            if rng.random() < 0.5:
                lo = int(rng.integers(0, rc.size - 400))
                parts.append(rc[lo:lo + int(rng.integers(50, 400))].copy())
            else:
                parts.append(rng.integers(0, 4, int(rng.integers(20, 300)), dtype=np.uint8))
        out = np.concatenate(parts)[:n]
        if with_n:
            out[rng.random(out.size) < 0.002] = dna.N
        return out

    return hq, mix(60_000, False), mix(9_000, True)


def _dest(pgs, which):
    hq, lq, npg = pgs
    return {"hq": hq, "lq": lq, "n": npg}[which]


@pytest.mark.parametrize("min_probes", ("default", "1"))
@pytest.mark.parametrize("index", ("shared", "fresh"))
@pytest.mark.parametrize("which", ("hq", "lq", "n"))
def test_mark_and_remove_as_the_reference(pgs, which, index, min_probes, monkeypatch):
    """The rewritten pg and its offset and length streams equal the
    reference's, through an index shared with the other pgs' scans or one
    built for this scan, on one thread or on as many as the CPUs allow."""
    hq = pgs[0]
    if min_probes == "1":
        monkeypatch.setattr(native, "SCAN_MIN_PROBES", 1)
    ref_index = ref_pg_match.align_matcher.build_index(hq, k=K, k1=K1)
    want = ref_pg_match._mark_and_remove(hq, ref_index, _dest(pgs, which), MIN_LEN,
                                         which == "hq")
    if index == "shared":
        idx = pg_match.scan_index(hq)
        for other in ("hq", "lq", "n"):
            if other != which:
                pg_match._mark_and_remove(hq, idx, _dest(pgs, other), MIN_LEN, other == "hq")
    else:
        idx = pg_match.scan_index(hq)
    got = pg_match._mark_and_remove(hq, idx, _dest(pgs, which), MIN_LEN, which == "hq")
    idx.close()
    assert want[1].size > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("min_probes", ("default", "1"))
@pytest.mark.parametrize("pre", ("precomputed", "none"))
def test_match_pgs_in_pg_as_the_reference(pgs, pre, min_probes, monkeypatch):
    hq, lq, npg = pgs
    if min_probes == "1":
        monkeypatch.setattr(native, "SCAN_MIN_PROBES", 1)
    want = ref_pg_match.match_pgs_in_pg(hq, lq, npg, MIN_LEN)
    got = pg_match.match_pgs_in_pg(
        hq, lq, npg, MIN_LEN,
        pre=pg_match.self_match_precompute(hq, MIN_LEN) if pre == "precomputed" else None)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert [(j.label, j.data) for j in got[3]] == [(j.label, j.data) for j in want[3]]


# ------------------------------------------------------------- one encode

def test_an_encode_builds_one_index(tmp_path):
    """One encode builds the hq pg's index once, in the self-match thread,
    and the writer's LQ and N scans reuse it; each scan span carries its
    threads and runs."""
    path = str(tmp_path / "in.fastq")
    synth_fastq(path, 6000, 100, 15000, seed=31, n_frac=0.05, lowq_frac=0.3)
    stats = encoder.encode(PgRCParams(src_fastq=path, output=str(tmp_path / "o.pgtc")),
                           device=torch.device("cpu"))
    scans = [s for s in stats.spans if s["name"] in ("selfmatch.scan", "pgmatch.scan")]
    by_name = [s["name"] for s in scans]
    assert by_name.count("selfmatch.scan") == 1 and by_name.count("pgmatch.scan") == 2
    assert stats.counters["pgmatch.index_builds"] == 1
    assert stats.counters["pgmatch.index_reuses"] == 2
    for s in scans:
        assert s["attrs"]["threads"] >= 1 and s["attrs"]["runs"] >= 0
    assert {s["thread"] for s in scans} == {"selfmatch", "pgseq"}
