"""The overlap sweep's column-major table: the upload against the reference's
row-major lanes, kernel D (both forms) on compacted views of the table, and
the wrappers' layout checks. Every value is an integer: equality is exact."""
import numpy as np
import pytest
import torch

from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu_torch import state
from pgrc_tpu_torch.core import packed
from pgrc_tpu_torch.kernels import sweep, sweep_compact, sweep_init


def codes_of(n, L, with_n, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    if with_n:
        codes[rng.random((n, L)) < 0.03] = 4
        codes[3] = 4
    return codes


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("L", [16, 17, 100, 129, 255])
def test_sweep_upload_is_the_row_major_upload_transposed(L, with_n, monkeypatch):
    """The sweep's upload (in chunks of rows, n off the chunk) equals the
    row-major upload of the reference's packed lanes, transposed: lanes [W+1,
    n], N mask [Wn+1, n], each column contiguous and starting on a 128-byte
    line."""
    monkeypatch.setattr(state, "UPLOAD_CHUNK_ROWS", 333)
    n = 1000
    lanes, nmask = ref_packed.pack_lanes(codes_of(n, L, with_n, L))
    assert (nmask is not None) == with_n
    rows = state.lanes_to_device(lanes, nmask, "cpu")
    cols = state.sweep_lanes_to_device(lanes, nmask, "cpu")
    for r, c, a in zip(rows, cols, (lanes, nmask)):
        if a is None:
            assert r is None and c is None
            continue
        assert c.dtype == torch.int32 and tuple(c.shape) == (a.shape[1], n)
        assert c.stride(1) == 1 and c.stride(0) >= n and c.stride(0) % packed.COL_ALIGN == 0
        assert torch.equal(c, r.t())
        np.testing.assert_array_equal(c.t().numpy().view(np.uint32), a)


def compacted_table(with_n):
    """A table after one compaction, as find_overlaps keeps it: every array a
    view of kernel H's outputs at the kept rows, so the lanes' column stride
    exceeds the rows; with the rolled hashes of the table's first round."""
    n, L = 700, 40
    codes = codes_of(n, L, with_n, 5 + with_n)
    codes[::7] = codes[1::7][: codes[::7].shape[0]]        # equal reads: entries pair
    lanes, nmask = state.sweep_lanes_to_device(*ref_packed.pack_lanes(codes), "cpu")
    h0, h0b = sweep_init.sweep_full_hashes(lanes, nmask, L)
    rng = np.random.default_rng(2)
    a_s = torch.from_numpy(rng.random(n) < 0.7)
    a_p = torch.from_numpy(rng.random(n) < 0.7)
    table = (lanes, nmask, torch.arange(n, dtype=torch.int32), h0, h0.clone(), h0b,
             h0b.clone(), a_s, a_p)
    new, counts = sweep_compact.sweep_compact(*table)
    kept = int(counts[0])
    assert 0 < kept < n
    return [None if v is None else v[..., :kept] for v in new], L


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("form", ["sweep_roll_entries", "sweep_roll_records"])
def test_roll_on_a_compacted_view_equals_a_contiguous_copy(form, with_n):
    """Kernel D and its sharded form on a compacted table (lanes [:, :kept]
    of wider storage, column stride > rows) equal them on a contiguous copy
    of the same rows, every round to the sweep's end: the rolled hashes, the
    entries and their counts."""
    view, L = compacted_table(with_n)
    lanes, nmask, ids, h, p, h2, p2, a_s, a_p = view
    assert lanes.stride(0) > lanes.shape[1] and lanes.stride(1) == 1
    copy = [None if v is None else v.contiguous() for v in view]
    assert copy[0].stride(0) == copy[0].shape[1]
    if with_n:
        assert nmask.stride(0) > nmask.shape[1]
    n = ids.numel()
    runs = []
    for lanes_t, nmask_t in ((lanes, nmask), (copy[0], copy[1])):
        hashes = [t.clone() for t in (h, p, h2, p2)]
        bufs = (sweep.round_buffers(n, "cpu") if form == "sweep_roll_entries"
                else sweep.record_buffers(n, "cpu"))
        if form == "sweep_roll_records":
            bufs[0].fill_(-1)
        rounds = []
        for i in range(1, L):
            if form == "sweep_roll_entries":
                count = sweep.sweep_roll_entries(lanes_t, nmask_t, a_s, a_p, i, L, *hashes, *bufs)
                m = int(count)
                rounds.append((m, bufs[0][:m].clone(), bufs[1][:m].clone(),
                               *(t.clone() for t in hashes)))
            else:
                counts = sweep.sweep_roll_records(lanes_t, nmask_t, a_s, a_p, i, L, *hashes, ids,
                                                  *bufs)
                rounds.append((counts.tolist(), bufs[0].clone(), *(t.clone() for t in hashes)))
        runs.append(rounds)
    assert len(runs[0]) == L - 1
    for got, want in zip(*runs):
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
    assert any(r[0] != 0 for r in runs[0])


def refused_tables():
    """(label, lanes) pairs of 50 rows that no sweep kernel takes: columns
    that are not contiguous, and a column stride below the rows."""
    lanes, _ = state.lanes_to_device(*ref_packed.pack_lanes(codes_of(50, 100, False, 1)), "cpu")
    flat = torch.zeros(8 * 50, dtype=torch.int32)
    return {"columns not contiguous": lanes.t(),
            "column stride below the rows": flat.as_strided((8, 50), (49, 1))}


KERNELS = ["sweep_roll_entries", "sweep_roll_records", "sweep_full_hashes", "sweep_compact"]


@pytest.mark.parametrize("fault", ["columns not contiguous", "column stride below the rows"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_wrappers_refuse_other_layouts(kernel, fault):
    """Kernels D (both forms), G and H refuse lanes whose columns are not
    contiguous (stride(1) != 1, e.g. a row-major table transposed) or whose
    column stride is below the rows: on the CPU as on the card, before any
    work. The same table in the sweep's layout is taken."""
    n, L = 50, 100
    bad = refused_tables()[fault]
    assert bad.shape == (8, n)
    good = packed.cols_copy(bad.t().contiguous().t()) if fault == "columns not contiguous" \
        else packed.empty_cols(8, n, "cpu").zero_()
    hashes = [torch.zeros(n, dtype=torch.int64) for _ in range(4)]
    flags = [torch.ones(n, dtype=torch.bool) for _ in range(2)]
    ids = torch.arange(n, dtype=torch.int32)

    def call(lanes):
        if kernel == "sweep_roll_entries":
            return sweep.sweep_roll_entries(lanes, None, *flags, 1, L, *hashes,
                                            *sweep.round_buffers(n, "cpu"))
        if kernel == "sweep_roll_records":
            return sweep.sweep_roll_records(lanes, None, *flags, 1, L, *hashes, ids,
                                            *sweep.record_buffers(n, "cpu"))
        if kernel == "sweep_full_hashes":
            return sweep_init.sweep_full_hashes(lanes, None, L)
        return sweep_compact.sweep_compact(lanes, None, ids, *hashes, *flags)

    with pytest.raises(ValueError, match="contiguous" if "contiguous" in fault else "stride"):
        call(bad)
    call(good)
