"""Kernels K and L, the matcher's interleaved-anchor rescue, through their
plain versions on the CPU, held against pgrc_tpu's `_build_rescue_index`
and `_interleaved_rescue` on both strands (the reverse complement with
codes above 3 set to 0, as the reference's match_reads makes it), and the
whole rescue through match_reads against the reference's: burst errors,
reads with N, k1 2, 4 and 8, buckets the cap cuts, ties on mismatches,
windows at both ends of the pg, L 100 and 150, the wide probe, the
16-read gate, the `rows=` path and a pg that holds N."""
import numpy as np
import pytest
import torch

from pgrc_tpu.align import matcher as ref
from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu_torch import state
from pgrc_tpu_torch.align import matcher as port
from pgrc_tpu_torch.kernels import rescue as kr
from pgrc_tpu_torch.utils import trace
from test_torch_align import burst_errors

K = 16


def ref_table(pg, k, k1):
    """The reference's CSR index as K's table: each bucket's first
    TABLE_CAP entries, (pos / k1 << 12) | (hash & 0xFFF), -1 past them."""
    pos, hs, starts, bits = ref._build_rescue_index(pg, k, k1)
    assert bits == kr.BUCKET_BITS
    table = np.full((1 << bits, kr.TABLE_CAP), -1, dtype=np.int64)
    cnt = np.diff(starts)
    for c in range(kr.TABLE_CAP):
        b = np.nonzero(cnt > c)[0]
        j = starts[b] + c
        table[b, c] = (pos[j] // k1 << kr.LOW_BITS) | (hs[j].astype(np.int64) & 0xFFF)
    return table, cnt


def ref_rescue(reads, pg, k, k1, max_mis):
    """(mis [2, n], pos [2, n]) of the reference's two rescue calls."""
    ridx = ref._build_rescue_index(pg, k, k1)
    rc = ref_packed.revcomp_codes_matrix(reads)
    rc[rc > 3] = 0
    got = [ref._interleaved_rescue(r, pg, k, max_mis, k1=k1, ridx=ridx) for r in (reads, rc)]
    return np.stack([g[0] for g in got]), np.stack([g[1] for g in got])


def port_rescue(reads, pg, k, k1, max_mis):
    return port.rescue(reads, pg, state.pg_lanes_to_device(pg, "cpu"), k, k1, max_mis)


def assert_rescue_equal(reads, pg, k1, max_mis, k=K):
    want = ref_rescue(reads, pg, k, k1, max_mis)
    got = port_rescue(reads, pg, k, k1, max_mis)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return want


def sampled_reads(rng, pg, n, L, starts=None):
    starts = rng.integers(0, pg.size - L + 1, size=n) if starts is None else starts
    return pg[np.asarray(starts)[:, None] + np.arange(L)[None, :]].copy()


def odd_errors(reads, step=14):
    """An error every `step` columns from column 1: every contiguous 32-mer
    dies, interleaved anchors of the other parity live."""
    cols = np.arange(1, reads.shape[1], step)
    reads[:, cols] = (reads[:, cols] + 1) % 4
    return reads


def half_reverse(rng, reads):
    rc = rng.random(reads.shape[0]) < 0.5
    reads[rc] = ref_packed.revcomp_codes_matrix(reads[rc])
    return reads


# --- K -----------------------------------------------------------------


@pytest.mark.parametrize("k1", [2, 4, 8])
@pytest.mark.parametrize("pg_len", [60_000, 60_001, 2 * K + 5])
def test_table_matches_reference_index(k1, pg_len):
    """Each bucket's first four entries in ascending position, with the
    low 12 bits of their hash, and nothing past them."""
    pg = np.random.default_rng(pg_len + k1).integers(0, 4, size=pg_len, dtype=np.uint8)
    want, _ = ref_table(pg, K, k1)
    got = kr.rescue_table(state.pg_lanes_to_device(pg, "cpu"), pg_len, K, k1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_from_a_pg_with_n_reads_its_codes():
    """A pg holding N: K hashes its 1-byte codes (N as 4), not the lanes
    (N as A), and equals the reference; from the lanes it would not."""
    rng = np.random.default_rng(5)
    pg = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    pg[rng.random(pg.size) < 0.02] = 4
    want, _ = ref_table(pg, K, 2)
    lanes = state.pg_lanes_to_device(pg, "cpu")
    got = kr.rescue_table(lanes, pg.size, K, 2, torch.from_numpy(pg))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(kr.rescue_table(lanes, pg.size, K, 2).numpy(), want)


def test_table_short_pg_is_empty():
    pg = np.zeros(2 * K - 1, dtype=np.uint8)
    got = kr.rescue_table(state.pg_lanes_to_device(pg, "cpu"), pg.size, K, 2)
    assert kr.n_entries(pg.size, K, 2) == 0 and (got == -1).all()


def test_table_refuses_wrong_shapes():
    pg = np.zeros(1000, dtype=np.uint8)
    lanes = state.pg_lanes_to_device(pg, "cpu")
    with pytest.raises(ValueError):
        kr.rescue_table(lanes, 2000, K, 2)
    with pytest.raises(ValueError):
        kr.rescue_table(lanes, 1000, 17, 2)
    with pytest.raises(ValueError):
        kr.rescue_table(lanes, 1000, K, 2, torch.zeros(999, dtype=torch.uint8))


# --- L and the rescue --------------------------------------------------


def test_burst_errors_match_reference():
    """test_align.test_burst_error_rescue's input (a repeat-rich pg, bursts
    in half the reads) on both strands."""
    pg, reads, k, max_mis = burst_errors()
    mis, _ = assert_rescue_equal(reads, pg, 2, max_mis, min(k, K))
    assert (mis[0] != 255).sum() > 100


@pytest.mark.parametrize("k1", [2, 4, 8])
@pytest.mark.parametrize("L", [100, 150])
def test_rescue_matches_reference(k1, L):
    """Reads with an error every 14 columns, half of them reverse
    complemented: the forward rows find the forward reads, the reverse
    complement rows the others."""
    rng = np.random.default_rng(k1 * 1000 + L)
    pg = rng.integers(0, 4, size=40_000, dtype=np.uint8)
    reads = half_reverse(rng, odd_errors(sampled_reads(rng, pg, 600, L)))
    mis, _ = assert_rescue_equal(reads, pg, k1, L // 3)
    assert (mis[0] != 255).sum() > 30 and (mis[1] != 255).sum() > 30


@pytest.mark.parametrize("L", [100, 150])
def test_reads_with_n_match_reference(L):
    """Forward N (code 4) enters the hash as 4 and never matches a pg
    symbol; the reverse complement carries it as 0."""
    rng = np.random.default_rng(L)
    pg = rng.integers(0, 4, size=30_000, dtype=np.uint8)
    reads = half_reverse(rng, sampled_reads(rng, pg, 500, L))
    n_at = rng.random(reads.shape) < 0.03
    reads[n_at] = 4
    mis, _ = assert_rescue_equal(reads, pg, 2, L // 3)
    has_n = n_at.any(axis=1)
    assert ((mis.min(axis=0) != 255) & has_n).sum() > 50


def cap_case(k1=2):
    """Copies 0-3 of a unit U differ from U at one column e; copies 4-7 are
    U. Reads of copy 5 have errors at e - 2 and e + 2, which kill every
    anchor over e, so each live anchor's bucket lists copies 0-3 first (the
    cap cuts it at four): the reference finds copy 0 with 3 mismatches and
    never sees copy 4 with 2."""
    rng = np.random.default_rng(11)
    unit_len, L, e = 256, 100, 50
    unit = rng.integers(0, 4, size=unit_len, dtype=np.uint8)
    copies = []
    for c in range(8):
        u = unit.copy()
        if c < 4:
            u[e] = (u[e] + 1) % 4
        copies.append(u)
    head = rng.integers(0, 4, size=512, dtype=np.uint8)
    pg = np.concatenate([head, *copies, rng.integers(0, 4, size=512, dtype=np.uint8)])
    start = head.size + 5 * unit_len
    reads = sampled_reads(rng, pg, 20, L, [start] * 20)
    for col in (e - 2, e + 2):
        reads[:, col] = (reads[:, col] + 2) % 4
    return pg, reads, head.size, unit_len, k1


def test_bucket_cap_skips_a_hash_equal_fifth_entry():
    pg, reads, head, unit_len, k1 = cap_case()
    _, cnt = ref_table(pg, K, k1)
    assert cnt.max() >= 8
    mis, pos = assert_rescue_equal(reads, pg, k1, 33)
    assert (mis[0] == 3).all() and (pos[0] == head).all()


def test_equal_mismatches_take_the_lower_start():
    """Two exact copies of a region: a read of the second takes the first."""
    rng = np.random.default_rng(12)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    spacer = rng.integers(0, 4, size=1000, dtype=np.uint8)
    pg = np.concatenate([spacer[:500], unit, spacer[500:], unit, spacer[:200]])
    second = 500 + 300 + 500
    reads = odd_errors(sampled_reads(rng, pg, 20, 100, second + np.arange(20) * 2))
    mis, pos = assert_rescue_equal(reads, pg, 2, 33)
    assert (mis[0] != 255).all()
    np.testing.assert_array_equal(pos[0], 500 + np.arange(20) * 2)


@pytest.mark.parametrize("L", [100, 150])
def test_windows_at_both_ends_of_the_pg(L):
    rng = np.random.default_rng(13)
    pg = rng.integers(0, 4, size=9_000, dtype=np.uint8)
    starts = [0, 0, 1, pg.size - L, pg.size - L, pg.size - L - 1] * 4
    reads = odd_errors(sampled_reads(rng, pg, len(starts), L, starts))
    mis, pos = assert_rescue_equal(reads, pg, 2, L // 3)
    assert {0, pg.size - L} <= set(pos[0][mis[0] != 255].tolist())


def test_max_mismatches_bounds_the_rescue():
    rng = np.random.default_rng(14)
    pg = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    reads = odd_errors(sampled_reads(rng, pg, 200, 100))    # 7 mismatches
    more = np.array([3, 5, 7, 9, 11, 17, 19, 21, 23, 25])     # 10 more, odd columns
    reads[::2, more] = (reads[::2, more] + 1) % 4
    mis, _ = assert_rescue_equal(reads, pg, 2, 15)
    assert (mis[0] == 255).any() and (mis[0] != 255).any()
    assert_rescue_equal(reads, pg, 2, 300)   # above 254: the reference's uint8 rule


def test_pg_with_n_is_read_from_its_codes(monkeypatch):
    """The port's choice for a pg holding N (code 4; the lanes pack it as
    A): the matcher uploads the pg's 1-byte codes, K and L read them, and
    the rescue is the reference's, N against N a match; a pg without N
    goes up as its lanes alone."""
    rng = np.random.default_rng(15)
    pg = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    starts = rng.integers(0, pg.size - 100, size=300)
    n_cols = starts[:, None] + np.array([20, 61, 87])[None, :]
    pg[n_cols[::2].ravel()] = 4
    reads = odd_errors(sampled_reads(rng, pg, 300, 100, starts))
    seen = []
    real = kr.rescue_table

    def spy(lanes, pg_len, k, k1, pg_bytes=None):
        seen.append(pg_bytes is not None)
        return real(lanes, pg_len, k, k1, pg_bytes)

    monkeypatch.setattr(port, "rescue_table", spy)
    mis, _ = assert_rescue_equal(reads, pg, 2, 33)
    assert (mis[0] != 255).sum() > 100
    clean = np.where(pg > 3, 0, pg).astype(np.uint8)
    assert_rescue_equal(reads, clean, 2, 33)
    assert seen == [True, False]


def test_best_refuses_out_of_range_arguments():
    pg = np.zeros(1000, dtype=np.uint8)
    lanes = state.pg_lanes_to_device(pg, "cpu")
    table = kr.rescue_table(lanes, pg.size, K, 2)
    codes = torch.zeros((4, 100), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kr.rescue_best(codes, table, lanes, pg.size, K, 2, 255)
    with pytest.raises(ValueError):
        kr.rescue_best(torch.zeros((4, 257), dtype=torch.uint8), table, lanes, pg.size, K, 2, 9)
    with pytest.raises(TypeError):
        kr.rescue_best(codes.to(torch.int32), table, lanes, pg.size, K, 2, 9)


# --- through match_reads -----------------------------------------------


def burst_match_case(n_burst, L=100, seed=21):
    """Clean reads and `n_burst` reads whose errors kill every contiguous
    24-mer, so only the rescue can place them."""
    rng = np.random.default_rng(seed)
    pg = rng.integers(0, 4, size=30_000, dtype=np.uint8)
    clean = half_reverse(rng, sampled_reads(rng, pg, 200, L))
    burst = half_reverse(rng, odd_errors(sampled_reads(rng, pg, n_burst, L), step=12))
    return pg, np.concatenate([clean, burst])


def match_both(pg, reads, k=24, max_mis=33, **kw):
    index = ref.build_index(pg, k=k, device_sort=True)
    want = ref.match_reads(reads, index, pg, max_mismatches=max_mis, accept_mis=0)
    with trace.record("test") as rec:
        got = port.match_reads(reads, index, pg, max_mismatches=max_mis, device="cpu", **kw)
    for a, b in ((got.pos, want.pos), (got.rc, want.rc), (got.mis, want.mis)):
        np.testing.assert_array_equal(a, b)
    return got, rec


@pytest.mark.parametrize("L", [100, 150])
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "wide"])
def test_match_reads_rescue_matches_reference(L, wide):
    """The rescue inside match_reads, the wide probe too; counters
    rescue.rows (the `rows` of span match.rescue) and rescue.found."""
    pg, reads = burst_match_case(120, L)
    got, rec = match_both(pg, reads, force_wide=wide)
    spans = {s.name: s for s in rec.spans}
    rows = rec.counters["rescue.rows"]
    assert rows == spans["match.rescue"].attrs["rows"] >= 16
    assert spans["match.rescue_index"].attrs["k1"] == 2
    found = rec.counters["rescue.found"]
    assert 0 < found <= rows and (got.mis[200:] != 255).sum() >= found > 30


@pytest.mark.parametrize("n_burst,ran", [(15, False), (40, True)])
def test_rescue_gate_of_16_missed_reads(monkeypatch, n_burst, ran):
    """Under 16 reads missed by both passes the rescue does not run, in
    either package."""
    pg, reads = burst_match_case(n_burst, seed=22)
    calls = []
    real = port.rescue
    monkeypatch.setattr(port, "rescue", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    got, rec = match_both(pg, reads)
    assert bool(calls) == ran and ("rescue.rows" in rec.counters) == ran
    if ran:
        assert calls[0] >= 16 and (got.mis[200:] != 255).any()


def test_match_reads_rescue_by_ids():
    """rows=: only the missed rows are gathered for the rescue, and the
    result is match_reads on the gathered matrix (and the reference's)."""
    pg, reads = burst_match_case(60, seed=23)
    rng = np.random.default_rng(23)
    order = rng.permutation(reads.shape[0] + 100)
    codes = np.concatenate([reads, rng.integers(0, 5, (100, 100), dtype=np.uint8)])[order]
    ids = np.argsort(order)[: reads.shape[0]]
    index = ref.build_index(pg, k=24, device_sort=True)
    got = port.match_reads(codes, index, pg, max_mismatches=33, device="cpu", rows=ids)
    want, _ = match_both(pg, codes[ids])
    for a, b in ((got.pos, want.pos), (got.rc, want.rc), (got.mis, want.mis)):
        np.testing.assert_array_equal(a, b)
