"""The port's match_reads against the reference's on the inputs of
tests/test_align.py and on a repeat-rich pg: pos, rc and mis identical, in
the single-pass and two-pass (-l N) modes, with the wide (int64 position)
probe, and with the index cut into blocks.

Positions past 2^31 cannot be made here: the packed pg alone would be a
512 MB lane tensor in each test worker. The wide probe runs here on small
pgs through `force_wide`; chip_smoke.py holds it, with the blocked index,
on pgs of 300M and 2.3G symbols on the card."""
import numpy as np
import pytest

from pgrc_tpu.align import matcher as ref
from pgrc_tpu.core import packed
from pgrc_tpu_torch.align import matcher as port
from test_align import make_pg_and_reads


def exact_reads():
    pg, reads, *_ = make_pg_and_reads(500, 100, 20000, 0, seed=1)
    return pg, reads, 32, 33


def mismatch_reads():
    pg, reads, *_ = make_pg_and_reads(400, 100, 15000, 3, seed=2)
    reads[::9, 40] = 4   # N probes as A on both strands
    return pg, reads, 32, 33


def random_junk():
    rng = np.random.default_rng(3)
    pg = rng.integers(0, 4, size=30000, dtype=np.uint8)
    return pg, rng.integers(0, 4, size=(100, 100), dtype=np.uint8), 32, 10


def burst_errors():
    """test_align.test_burst_error_rescue's input: bursts kill every
    contiguous anchor of half the reads, which only the rescue finds."""
    rng = np.random.default_rng(7)
    unit = rng.integers(0, 4, size=350).astype(np.uint8)
    pg = np.concatenate([rng.integers(0, 4, size=5000).astype(np.uint8)]
                        + [unit] * 30
                        + [rng.integers(0, 4, size=5000).astype(np.uint8)])
    L, k = 100, 24
    starts = rng.integers(0, pg.size - L, size=300)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    for r in range(0, 300, 2):
        hit = np.arange(1, L, k // 2 * 2 + 1)
        reads[r, hit] = (reads[r, hit] + 1) % 4
    return pg, reads, k, L // 3


@pytest.mark.parametrize("make", [exact_reads, mismatch_reads, random_junk, burst_errors])
@pytest.mark.parametrize("lazy", [True, False], ids=["device-index", "host-index"])
def test_match_reads_matches_reference(make, lazy):
    pg, reads, k, max_mis = make()
    index = ref.build_index(pg, k=k, device_sort=lazy)
    a = ref.match_reads(reads, index, pg, max_mismatches=max_mis, accept_mis=0)
    b = port.match_reads(reads, index, pg, max_mismatches=max_mis, device="cpu")
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.rc, b.rc)
    np.testing.assert_array_equal(a.mis, b.mis)
    if make is not random_junk:
        assert (a.pos >= 0).mean() > 0.9


def divergent_repeats():
    """60 copies of a 300-symbol unit at 1% divergence between unique
    spacers: most anchors of a read occur in many copies, and the copy a
    block's join picks (its lowest position) depends on where blocks begin,
    so blocked and unblocked probes give different (equally valid) matches."""
    rng = np.random.default_rng(8)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    parts = [rng.integers(0, 4, size=10_000, dtype=np.uint8)]
    for _ in range(60):
        c = unit.copy()
        mut = rng.random(c.size) < 0.01
        c[mut] = (c[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        parts += [c, rng.integers(0, 4, size=200, dtype=np.uint8)]
    pg = np.concatenate(parts)
    L = 100
    starts = rng.integers(0, pg.size - L, size=600)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    err = rng.random(reads.shape) < 0.02
    reads[err] = (reads[err] + 1) % 4
    rc = rng.random(reads.shape[0]) < 0.5
    reads[rc] = packed.revcomp_codes_matrix(reads[rc])
    reads[::11, 30] = 4
    return pg, reads, 24, 33


@pytest.fixture(scope="module")
def repeats():
    pg, reads, k, max_mis = divergent_repeats()
    lazy = ref.build_index(pg, k=k, device_sort=True)
    host = ref.build_index(pg, k=k)
    single = ref.match_reads(reads, lazy, pg, max_mismatches=max_mis, accept_mis=0)
    return pg, reads, max_mis, {True: lazy, False: host}, single


def assert_same_match(a, b):
    np.testing.assert_array_equal(a.pos, b.pos)
    np.testing.assert_array_equal(a.rc, b.rc)
    np.testing.assert_array_equal(a.mis, b.mis)
    assert (a.pos >= 0).mean() > 0.9


def run_both(repeats_case, lazy, **kw):
    pg, reads, max_mis, indexes, _ = repeats_case
    a = ref.match_reads(reads, indexes[lazy], pg, max_mismatches=max_mis, **kw)
    b = port.match_reads(reads, indexes[lazy], pg, max_mismatches=max_mis,
                         device="cpu", **kw)
    assert_same_match(a, b)
    return a


@pytest.mark.parametrize("accept,env", [(2, None), (3, None), (0, "1")],
                         ids=["l2", "l3", "l0-PGRC_TPU_TWO_PASS"])
@pytest.mark.parametrize("lazy", [True, False], ids=["device-index", "host-index"])
def test_two_pass_matches_reference(repeats, monkeypatch, accept, env, lazy):
    """-l N: spread-offset pass 1, the leftovers' full fan-out in pass 2."""
    if env:
        monkeypatch.setenv("PGRC_TPU_TWO_PASS", env)
    a = run_both(repeats, lazy, accept_mis=accept)
    if accept:   # pass 1 accepted reads the full fan-out would match better
        assert (a.mis != repeats[4].mis).any()


@pytest.mark.parametrize("lazy", [True, False], ids=["device-index", "host-index"])
def test_wide_probe_matches_reference(repeats, lazy):
    a = run_both(repeats, lazy, accept_mis=0, force_wide=True)
    assert_same_match(a, repeats[4])          # the same matches as int32


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "wide"])
@pytest.mark.parametrize("block", [512, 4096])
@pytest.mark.parametrize("lazy", [True, False], ids=["device-index", "host-index"])
def test_blocked_index_matches_reference(repeats, lazy, block, wide):
    """Several index blocks, merged by (mismatches, position): the lazy
    index's lane blocks (32 or 4 here) and the host table's entry blocks
    (20 or 3)."""
    a = run_both(repeats, lazy, accept_mis=0, index_block=block, force_wide=wide)
    if lazy:   # the lane blocks change which copy some reads take
        assert (a.pos != repeats[4].pos).any()


def test_unported_matcher_paths_raise(repeats):
    """Two-pass matching at -l 2 on a blocked index runs and equals the
    reference; what the reference itself refuses, a pg past 2^35 symbols,
    the port refuses too."""
    run_both(repeats, True, accept_mis=2, index_block=512)
    pg, reads, max_mis, _, _ = repeats
    huge = ref.KmerIndex(hash_sorted=None, pos_sorted=None, k=24, k1=4,
                         pg_len=(1 << 35) + 1, sorted=False)
    for matcher, kw in ((ref, {}), (port, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="2\\^35"):
            matcher.match_reads(reads, huge, pg, max_mis, accept_mis=0, **kw)


@pytest.mark.parametrize("accept", [0, 2], ids=["single-pass", "l2"])
@pytest.mark.parametrize("lazy", [True, False], ids=["device-index", "host-index"])
def test_key_buffer_across_batches_and_blocks(repeats, monkeypatch, lazy, accept):
    """One key buffer per pass serves every (batch, block) join: with the
    batch cap lowered to 256 rows and the index cut into blocks, each join
    rewrites the buffer's head (kernel B, or the host table's keys) and
    tail (kernel C), and the matches stay the reference's."""
    heads = []
    real = port.write_head

    def counted(block, keys, *args):
        heads.append(keys.data_ptr())
        return real(block, keys, *args)

    monkeypatch.setattr(port, "_batch_cap", lambda i_pad, S: 256)
    monkeypatch.setattr(port, "write_head", counted)
    pg, reads, max_mis, indexes, _ = repeats
    a = run_both(repeats, lazy, accept_mis=accept, index_block=4096)
    blocks = port.device_index(indexes[lazy], pg, "cpu", max_block=4096)[0]
    assert len(blocks) > 1
    rows = 2 * reads.shape[0]
    if accept == 0:
        assert len(heads) == len(blocks) * -(-rows // 256)
        assert len(set(heads)) == 1      # one buffer for the whole pass
    assert len(heads) > len(blocks) * 4
    assert (a.pos >= 0).mean() > 0.9
