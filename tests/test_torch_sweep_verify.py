"""Kernel J's plain version (`kernels.sweep_verify`: the exact check of a
device sweep table's links) against the reference's host link check
(pgrc_tpu's `_verify_links`): on column-major tables of reads of 37, 64, 100
and 150 symbols, without and with an N mask, packed from the rows, through
row ids into a larger matrix, and as a view of wider storage, the same links
cut and kept, with planted faults the check must find and good links it must
keep. Every value is an integer: equality is exact."""
import numpy as np
import pytest
import torch

from pgrc_tpu.overlap import greedy_scs as ref
from pgrc_tpu_torch import state
from pgrc_tpu_torch.core import packed
from pgrc_tpu_torch.kernels import sweep_verify

A, N = 0, 4
# planted link -> whether the check keeps it
PLANTS = {
    "good": True,
    "overlap shortened by 3": False,
    "one base flipped inside": False,
    "N against A inside": False,
    "N at the first and last symbol of both": True,
    "N at the first symbol of one": False,
    "N at the last symbol of one": False,
    "duplicate (o = L)": True,
    "duplicate with N (o = L)": True,
    "duplicate, last base flipped (o = L)": False,
    "o = 1": True,
    "o = 1, the symbol differs": False,
}
WITH_N = {k for k in PLANTS if "N" in k}


def plant(rng, L, kind):
    """Two reads x, y and the link x -> y at overlap o of one kind (PLANTS):
    y's first o symbols are x's last o, then the fault."""
    o = L if kind.startswith("duplicate") else 1 if kind.startswith("o = 1") else int(
        rng.integers(20, L - 1))
    x = rng.integers(0, 4, L, dtype=np.uint8)
    y = rng.integers(0, 4, L, dtype=np.uint8)
    y[:o] = x[L - o:]
    j = int(rng.integers(1, o - 1)) if o > 2 else 0
    if kind == "overlap shortened by 3":
        o -= 3
    elif kind == "one base flipped inside":
        x[L - o + j] = (x[L - o + j] + 1) % 4
    elif kind == "N against A inside":
        x[L - o + j], y[j] = N, A          # equal 2-bit codes, N bits differ
    elif kind == "N at the first and last symbol of both":
        x[L - o], x[L - 1], y[0], y[o - 1] = N, N, N, N
    elif kind == "N at the first symbol of one":
        x[L - o], y[0] = N, A
    elif kind == "N at the last symbol of one":
        x[L - 1], y[o - 1] = A, N
    elif kind == "duplicate with N (o = L)":
        x[[0, L // 2]] = N
        y[:] = x
    elif kind == "duplicate, last base flipped (o = L)":
        y[L - 1] = (y[L - 1] + 1) % 4
    elif kind == "o = 1, the symbol differs":
        y[0] = (x[L - 1] + 1) % 4
    return x, y, o


def link_set(L, with_n, seed):
    """Reads and their links, rows shuffled: each planted kind at 8 pairs,
    the true overlaps of reads along a genome ("genome"; with N in a few of
    their symbols), links to random reads at random overlaps ("wild") and
    rows without a link -> (codes [n, L], succ, ovl [n] int32, {kind: the
    rows that carry its links})."""
    rng = np.random.default_rng(seed)
    rows, succ, ovl, kind_of = [], [], [], []
    for kind in PLANTS:
        if kind in WITH_N and not with_n:
            continue
        for _ in range(8):
            x, y, o = plant(rng, L, kind)
            rows += [x, y]
            succ += [len(rows) - 1, -1]
            ovl += [o, 0]
            kind_of += [kind, None]
    genome = rng.integers(0, 4, 40 * L, dtype=np.uint8)
    starts = np.sort(rng.choice(40 * L - L, 300, replace=False))
    first = len(rows)
    rows += [genome[s:s + L] for s in starts]
    for i, s in enumerate(starts):
        nxt = starts[i + 1] if i + 1 < len(starts) else None
        linked = nxt is not None and nxt - s < L
        succ.append(first + i + 1 if linked else -1)
        ovl.append(L - (nxt - s) if linked else 0)
        kind_of.append("genome" if linked else None)
    codes = np.stack(rows)
    n = codes.shape[0]
    wild = rng.choice(first, 60, replace=False)
    wild = wild[np.array(succ)[wild] < 0]
    succ, ovl = np.array(succ, np.int32), np.array(ovl, np.int32)
    succ[wild] = rng.integers(0, n, wild.size)
    ovl[wild] = rng.integers(1, L + 1, wild.size)
    kind_of = np.array(kind_of, dtype=object)
    kind_of[wild] = "wild"
    if with_n:
        spots = rng.random(codes.shape) < 0.002
        spots[:first] = False              # the planted pairs keep their symbols
        codes[spots] = N
    perm = rng.permutation(n)              # row r of the shuffled set is old row perm[r]
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    succ_p = np.where(succ[perm] >= 0, inv[np.maximum(succ[perm], 0)], -1).astype(np.int32)
    kinds = {k: np.nonzero(kind_of[perm] == k)[0] for k in (*PLANTS, "genome", "wild")}
    return codes[perm], succ_p, ovl[perm], kinds


def table(codes, layout, rng):
    """The sweep's column-major table of `codes` on the CPU: packed from the
    rows, through ids into a larger matrix that holds them, or as the head
    rows of a table of more rows (a column stride past the rows)."""
    n = codes.shape[0]
    if layout == "rows":
        return state.sweep_lanes_to_device(*packed.pack_lanes(codes), "cpu")
    if layout == "ids":
        big = rng.integers(0, 5, (3 * n, codes.shape[1]), dtype=np.uint8)
        ids = np.sort(rng.choice(3 * n, n, replace=False))
        big[ids] = codes
        return state.sweep_lanes_to_device(*packed.pack_lanes(big, rows=ids), "cpu")
    more = np.concatenate([codes, rng.integers(0, 4, (97, codes.shape[1]), dtype=np.uint8)])
    lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(more), "cpu")
    out = tuple(None if t is None else t[:, :n] for t in (lanes, nmask))
    assert out[0].stride(0) > n
    return out


@pytest.mark.parametrize("layout", ["rows", "ids", "wider storage"])
@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("L", [37, 64, 100, 150])
def test_plain_check_cuts_what_the_host_check_cuts(L, with_n, layout):
    codes, succ, ovl, kinds = link_set(L, with_n, seed=L + 2 * with_n)
    lanes, nmask = table(codes, layout, np.random.default_rng(L))
    assert (nmask is not None) == with_n
    want = ref.OverlapResult(succ.copy(), ovl.copy(), L)
    ref._verify_links(want, codes)
    s, o = torch.from_numpy(succ.copy()), torch.from_numpy(ovl.copy())
    counts = torch.full((sweep_verify.COUNTS,), 7, dtype=torch.int32)
    sweep_verify.sweep_verify_links(lanes, nmask, L, s, o, counts)
    np.testing.assert_array_equal(s.numpy(), want.succ)
    np.testing.assert_array_equal(o.numpy(), want.overlap)
    linked = int((succ >= 0).sum())
    assert counts.tolist() == [linked, linked - int((want.succ >= 0).sum())]
    for kind, keep in PLANTS.items():
        if kind in WITH_N and not with_n:
            continue
        assert kinds[kind].size == 8
        assert ((want.succ[kinds[kind]] >= 0) == keep).all(), kind
    # the genome's true overlaps are kept (those without N, where N is), the
    # random links nearly all cut
    kept = want.succ[kinds["genome"]] >= 0
    assert kinds["genome"].size > 250 and (kept.all() if not with_n else 0.2 < kept.mean() < 1)
    assert (want.succ[kinds["wild"]] < 0).mean() > 0.8


def test_no_link_and_no_row():
    """A table whose rows have no link, and one of no rows: nothing cut,
    nothing counted."""
    codes = np.random.default_rng(1).integers(0, 4, (50, 100), dtype=np.uint8)
    lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes), "cpu")
    for n in (50, 0):
        s = torch.full((n,), -1, dtype=torch.int32)
        o = torch.zeros((n,), dtype=torch.int32)
        counts = torch.full((sweep_verify.COUNTS,), 3, dtype=torch.int32)
        sweep_verify.sweep_verify_links(lanes[:, :n], nmask, 100, s, o, counts)
        assert counts.tolist() == [0, 0] and (s == -1).all() and (o == 0).all()


@pytest.mark.parametrize("fault", ["no pad lane", "no N-mask pad word", "counts of 3"])
def test_the_wrapper_refuses_short_tables_and_buffers(fault):
    """J reads a row's pad word (the last symbols' funnel shift): a table
    without it is refused, as is a counts buffer of another size."""
    codes = np.random.default_rng(2).integers(0, 5, (40, 64), dtype=np.uint8)
    lanes, nmask = state.sweep_lanes_to_device(*packed.pack_lanes(codes), "cpu")
    s, o = torch.full((40,), -1, dtype=torch.int32), torch.zeros((40,), dtype=torch.int32)
    counts = torch.zeros(3 if fault == "counts of 3" else 2, dtype=torch.int32)
    if fault == "no pad lane":
        lanes = lanes[:-1]
    elif fault == "no N-mask pad word":
        nmask = nmask[:-1]
    with pytest.raises(ValueError):
        sweep_verify.sweep_verify_links(lanes, nmask, 64, s, o, counts)
