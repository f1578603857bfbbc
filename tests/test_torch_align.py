"""The port's match_reads against the reference's single-pass matcher on the
inputs of tests/test_align.py: pos, rc and mis identical."""
import numpy as np
import pytest

from pgrc_tpu.align import matcher as ref
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


def test_unported_matcher_paths_raise():
    pg, reads, k, max_mis = exact_reads()
    index = ref.build_index(pg, k=k, device_sort=True)
    with pytest.raises(NotImplementedError, match="two-pass"):
        port.match_reads(reads, index, pg, max_mis, accept_mis=2, device="cpu")
