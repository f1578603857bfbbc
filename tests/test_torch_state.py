"""Unsigned carriers and numpy <-> tensor state: bit-exact both ways."""
import numpy as np
import pytest
import torch

from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu_torch import state
from pgrc_tpu_torch.utils import uint

U32_EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.uint32)
U64_EDGES = np.array([0, 1, 2**31, 2**32 - 1, 2**63 - 1, 2**63, 2**64 - 1],
                     dtype=np.uint64)


def test_u32_round_trip_at_extremes():
    t = uint.np_u32_to_tensor(U32_EDGES, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(uint.tensor_to_np_u32(t), U32_EDGES)
    as64 = uint.i32_to_u32(t)
    np.testing.assert_array_equal(as64.numpy(), U32_EDGES.astype(np.int64))
    np.testing.assert_array_equal(uint.u32_to_i32(as64).numpy(), t.numpy())


def test_u64_round_trip_at_extremes():
    t = uint.np_u64_to_tensor(U64_EDGES, "cpu")
    np.testing.assert_array_equal(uint.tensor_to_np_u64(t), U64_EDGES)
    assert [uint.s64(int(v)) for v in U64_EDGES] == t.tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_u64_wrapping_arithmetic_matches_numpy(seed):
    rng = np.random.default_rng(seed)
    a = np.concatenate([U64_EDGES, rng.integers(0, 2**64, 64, dtype=np.uint64)])
    b = np.concatenate([U64_EDGES[::-1], rng.integers(0, 2**64, 64, dtype=np.uint64)])
    ta, tb = uint.np_u64_to_tensor(a, "cpu"), uint.np_u64_to_tensor(b, "cpu")
    with np.errstate(over="ignore"):
        for got, want in ((ta * tb, a * b), (ta + tb, a + b), (ta - tb, a - b)):
            np.testing.assert_array_equal(uint.tensor_to_np_u64(got), want)
    for s in (1, 32, 35, 63):
        np.testing.assert_array_equal(uint.tensor_to_np_u64(uint.lshr64(ta, s)),
                                      a >> np.uint64(s))
    a32 = (a & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    t32 = uint.np_u32_to_tensor(a32, "cpu")
    for s in (0, 1, 16, 31):
        np.testing.assert_array_equal(
            uint.lshr32(t32, s).numpy().astype(np.int64) & 0xFFFFFFFF,
            (a32 >> np.uint32(s)).astype(np.int64))


def test_order_key_sorts_unsigned_with_sentinels_last():
    rng = np.random.default_rng(2)
    vals = np.concatenate([U64_EDGES, rng.integers(0, 2**64, 200, dtype=np.uint64)])
    t = uint.np_u64_to_tensor(vals, "cpu")
    got = uint.tensor_to_np_u64(uint.from_order_key64(
        torch.sort(uint.order_key64(t)).values))
    np.testing.assert_array_equal(got, np.sort(vals))
    assert got[-1] == np.uint64(2**64 - 1)  # INV64 last


def test_k2_carrier_sorts_suffix_bit_and_inv32_last():
    gid = np.array([5, 0, 2**30 - 1, 7], dtype=np.int64)
    k2 = np.concatenate([gid | 0x80000000, [0xFFFFFFFF], gid])
    got = torch.sort(torch.from_numpy(k2)).values.numpy()
    np.testing.assert_array_equal(got, np.sort(k2.astype(np.uint32)).astype(np.int64))
    assert (got[:4] < 0x80000000).all() and got[-1] == 0xFFFFFFFF


@pytest.mark.parametrize("with_n", [False, True])
def test_state_round_trips(with_n):
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(37, 100), dtype=np.uint8)
    if with_n:
        codes[::5, 3] = 4
    lanes, nmask = ref_packed.pack_lanes(codes)
    assert (nmask is not None) == with_n
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    back_l, back_n = state.lanes_from_device(lt, nt)
    np.testing.assert_array_equal(back_l, lanes)
    if with_n:
        np.testing.assert_array_equal(back_n, nmask)
    h = rng.integers(0, 2**64, 37, dtype=np.uint64)
    np.testing.assert_array_equal(state.hashes_from_device(state.hashes_to_device(h, "cpu")), h)
    pg = rng.integers(0, 4, size=1000, dtype=np.uint8)
    pg_t = state.pg_lanes_to_device(pg, "cpu")
    np.testing.assert_array_equal(uint.tensor_to_np_u32(pg_t)[:-1], ref_packed.pack_text_2bit(pg))
    assert int(pg_t[-1]) == 0
    ihash = rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32)
    ipos = np.where(rng.random(50) < 0.1, -1, rng.integers(0, 2**31, 50)).astype(np.int32)
    got_h, got_p = state.index_from_device(*state.index_to_device(ihash, ipos, "cpu"))
    np.testing.assert_array_equal(got_h, ihash)
    np.testing.assert_array_equal(got_p, ipos)
    mis = torch.tensor([0, 33, 255], dtype=torch.uint8)
    pos = torch.tensor([5, 2**31 - 1, -1], dtype=torch.int32)
    m, p = state.match_from_device(mis, pos)
    assert m.dtype == np.uint8 and p.dtype == np.int64
    assert m.tolist() == [0, 33, 255] and p.tolist() == [5, 2**31 - 1, -1]


@pytest.mark.parametrize("n", [1, 16, 1000, 4099])
def test_pg_packing_in_chunks_matches_reference(n):
    """The pg packer works in chunks of lanes (a 2G-symbol pg would take the
    reference's u32 temporaries, 16 bytes per symbol): the reference's lanes
    at every length and chunk edge, N (code 4) packed as A."""
    rng = np.random.default_rng(n)
    pg = rng.integers(0, 5, size=n, dtype=np.uint8)
    out = np.zeros(-(-n // 16), np.uint32)
    state.pack_text_2bit(pg, out, chunk_lanes=7)
    np.testing.assert_array_equal(out, ref_packed.pack_text_2bit(pg))


def test_wide_index_positions_round_trip():
    """int64 positions (the wide probe) past 2^31 cross as they are; the
    int32 form refuses them rather than wrapping."""
    ihash = np.arange(4, dtype=np.uint32)
    ipos = np.array([-1, 0, 2**31, 2**35 - 1], dtype=np.int64)
    h_t, p_t = state.index_to_device(ihash, ipos, "cpu", wide=True)
    assert p_t.dtype == torch.int64
    np.testing.assert_array_equal(state.index_from_device(h_t, p_t)[1], ipos)
    with pytest.raises(ValueError, match="wide"):
        state.index_to_device(ihash, ipos, "cpu")
