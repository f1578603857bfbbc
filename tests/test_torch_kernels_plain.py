"""Each kernel's plain PyTorch version against the JAX reference, at the main
path's shapes, shrunk. Every value is an integer: equality is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgrc_tpu.align import matcher as ref_matcher
from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu.overlap import greedy_scs as ref_scs
from pgrc_tpu_torch import state
from pgrc_tpu_torch.align import matcher as port_matcher
from pgrc_tpu_torch.core import packed as port_packed
from pgrc_tpu_torch.kernels import kmer_hash, strand_rows, sweep, verify
from pgrc_tpu_torch.utils import uint

L = 100
R = 1024


@pytest.fixture(scope="module")
def pg_case():
    """A pg whose length is not a lane multiple, reads sampled from it with
    ~3% substitutions, a quarter of them random junk, and the reference's
    device index (lazy: built on its device from the packed pg)."""
    rng = np.random.default_rng(11)
    pg = rng.integers(0, 4, size=40_013, dtype=np.uint8)
    starts = rng.integers(0, pg.size - L + 1, R)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    err = rng.random(reads.shape) < 0.03
    reads[err] = (reads[err] + 1) % 4
    reads[: R // 4] = rng.integers(0, 4, size=(R // 4, L), dtype=np.uint8)
    return pg, reads


def _ref_device_index(pg, k, k1=4):
    index = ref_matcher.build_index(pg, k=k, k1=k1, device_sort=True)
    blocks, pg_lanes_d, wpf, i_pad = ref_matcher.device_index(index, pg)
    assert len(blocks) == 1
    ihash, ipos = (np.asarray(a) for a in blocks[0])
    return index, ihash, ipos, np.asarray(pg_lanes_d), wpf, i_pad


def _key_buffer(ihash, ipos, P):
    """A join's key buffer: the index keys of (ihash, ipos), then room for P
    probe keys (garbage, as torch.empty leaves it)."""
    keys = torch.full((ipos.numel() + P,), 12345, dtype=torch.int64)
    keys[:ipos.numel()] = kmer_hash.index_keys(ihash, ipos)
    return keys


def _split_keys(keys):
    """Join keys -> (u32 hashes: the high word + 2^31, key2: the low word)
    as numpy."""
    return (((keys >> 32) + (1 << 31)).numpy().astype(np.uint32),
            (keys & 0xFFFFFFFF).numpy())


@pytest.mark.parametrize("n_verify", [6, 1])
def test_probe_verify_matches_make_probe(pg_case, n_verify):
    """Kernel A (with C and the join before it): the port's probe against
    the reference's jitted `_make_probe` on the same lanes, index and pg."""
    pg, reads = pg_case
    k = 32
    index, ihash, ipos, pg_lanes, wpf, i_pad = _ref_device_index(pg, k)
    offs = ref_matcher.probe_offsets(L, k, 3)
    lanes, _ = ref_packed.pack_lanes(reads)
    fn = jax.jit(ref_matcher._make_probe(R, L, offs, k, i_pad, wpf, 33,
                                         n_verify=n_verify))
    mis_r, pos_r = jax.device_get(fn(jnp.asarray(lanes), jnp.asarray(ihash),
                                     jnp.asarray(ipos), jnp.asarray(pg_lanes),
                                     index.pg_len))
    ih_t, ip_t = state.index_to_device(ihash, ipos, "cpu")
    mis, pos = port_matcher.probe(
        uint.np_u32_to_tensor(lanes, "cpu"), offs,
        _key_buffer(ih_t, ip_t, R * len(offs)), ip_t, uint.np_u32_to_tensor(pg_lanes, "cpu"),
        index.pg_len, L, k, 33, n_verify)
    np.testing.assert_array_equal(mis.numpy(), mis_r)
    np.testing.assert_array_equal(pos.numpy(), pos_r)
    assert 0.5 < (mis_r != 255).mean() < 1.0


def _run_xla_numpy(pg, rl, st):
    """exp_pallas_verify.run_xla (the Pallas kernel's plain reference) in
    numpy: per-start packed mismatch counts, 9 pg lanes per window, W = 7
    read lanes of 8 (lane 7 masked out)."""
    W = (L + 15) // 16
    lane_mask = np.full(8, 0xFFFFFFFF, dtype=np.uint64)
    lane_mask[W - 1] = (0xFFFFFFFF << (32 - 2 * (L - (W - 1) * 16))) & 0xFFFFFFFF
    lane_mask[7] = 0
    q = st >> 4
    s2 = ((st & 15) << 1).astype(np.uint64)[..., None]
    lane_ids = np.clip(q[..., None] + np.arange(9)[None, None, :], 0, pg.size - 1)
    tl = pg[lane_ids].astype(np.uint64)
    hi = (tl[..., :8] << s2) & np.uint64(0xFFFFFFFF)
    lo = np.where(s2 > 0, tl[..., 1:9] >> (np.uint64(32) - s2), np.uint64(0))
    x = ((hi | lo) & lane_mask) ^ (rl[:, None, :].astype(np.uint64) & lane_mask)
    y = (x | (x >> np.uint64(1))) & np.uint64(0x55555555)
    bits = np.unpackbits(y.astype("<u4").view(np.uint8), axis=-1)
    return bits.reshape(*y.shape, 32).sum(axis=(-1, -2)).astype(np.int64)


def test_verify_matches_pallas_plain_reference():
    """Kernel A's window count against the Pallas experiment's own plain
    reference: R=1024, S=3, random lanes, start residues 0 and 15 included."""
    rng = np.random.default_rng(5)
    pgl, S = 1 << 12, 3
    pg = rng.integers(0, 2**32, size=pgl, dtype=np.uint64).astype(np.uint32)
    rl = rng.integers(0, 2**32, size=(R, 8), dtype=np.uint64).astype(np.uint32)
    st = rng.integers(0, (pgl - 8) * 16, size=(R, S)).astype(np.int64)
    st[:, 0] -= st[:, 0] % 16           # residue 0: no cross-lane shift
    st[:, 1] += 15 - st[:, 1] % 16      # residue 15: the widest shift
    want = _run_xla_numpy(pg, rl, st)
    rl_t, pg_t = uint.np_u32_to_tensor(rl, "cpu"), uint.np_u32_to_tensor(pg, "cpu")
    st_t = torch.from_numpy(st)
    for j in range(S):
        got = verify.window_mismatches(rl_t, st_t[:, j], pg_t, L)
        np.testing.assert_array_equal(got.numpy(), want[:, j])
    # best over all slots, ties to the lower start: the (mis, pos) minimum
    mis, pos = verify.verify_best_plain(
        rl_t, st_t.to(torch.int32), torch.ones((R, S), dtype=torch.bool), pg_t,
        pgl * 16, L, 254, S)
    best = np.lexsort((st, want), axis=1)[:, 0]
    np.testing.assert_array_equal(mis.numpy(), want[np.arange(R), best])
    np.testing.assert_array_equal(pos.numpy(), st[np.arange(R), best])


@pytest.mark.parametrize("k,k1", [(32, 4), (24, 2)])
def test_index_hash_matches_reference(pg_case, k, k1):
    """Kernel B against the reference's device build_fn and against the host
    `_window_hashes` sampled every k1, up to the last window."""
    pg, _ = pg_case
    index, ihash, ipos, pg_lanes, _, _ = _ref_device_index(pg, k, k1)
    pg_t = state.pg_lanes_to_device(pg, "cpu")
    m = (pg_t.numel() - 1) * 16 // k1
    key_t, p_t = kmer_hash.index_kmer_hash_plain(pg_t, k, k1, pg.size, m)
    (h, key2), p = _split_keys(key_t), p_t.numpy()
    np.testing.assert_array_equal(p, ipos[:m])
    np.testing.assert_array_equal(key2, np.where(p >= 0, 0, 0xFFFFFFFF))
    assert (ipos[m:] == -1).all()
    valid = p >= 0
    np.testing.assert_array_equal(h[valid], ihash[:m][valid])
    host = ref_matcher._window_hashes(pg, k)[::k1]
    assert valid.sum() == host.size and p[valid][-1] > pg.size - k - k1
    np.testing.assert_array_equal(h[valid], host)


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("k,k1", [(32, 4), (24, 2), (37, 4)])
def test_index_block_hash_matches_reference(pg_case, k, k1, wide):
    """Kernel B one block at a time, in its key form: every block b of the
    reference's `_build_index_build_fn(wpf, wp, k, k1, wide)` at
    lane_off = b*wp, the hash in the key's high word, key2 0 exactly where
    the position is live and U32INV elsewhere. The port builds only the
    entries of the pg's own lanes (m per block); the reference's entries
    past them are inert (-1), like a block past the pg's last lane."""
    pg, _ = pg_case
    pg_t = state.pg_lanes_to_device(pg, "cpu")
    n_lanes = pg_t.numel() - 1
    wpf = ref_matcher._probe_bucket(n_lanes + 1)
    wp = wpf // 4
    lanes = np.zeros(wpf, np.uint32)
    lanes[:n_lanes] = uint.tensor_to_np_u32(pg_t[:-1])
    build_fn = ref_matcher._build_index_build_fn(wpf, wp, k, k1, wide)
    for b in range(wpf // wp):
        ih, ip = (np.asarray(a) for a in build_fn(jnp.asarray(lanes), np.int64(b * wp),
                                                  pg.size))
        m = max(0, min(wp, n_lanes - b * wp)) * 16 // k1
        key_t, p_t = kmer_hash.index_kmer_hash_plain(pg_t, k, k1, pg.size, m, b * wp, wide)
        assert p_t.dtype == (torch.int64 if wide else torch.int32) == \
            (torch.int64 if ip.dtype == np.int64 else torch.int32)
        np.testing.assert_array_equal(p_t.numpy(), ip[:m])
        h, key2 = _split_keys(key_t)
        np.testing.assert_array_equal(h, ih[:m])
        np.testing.assert_array_equal(((key_t >> 32) + (1 << 31)).numpy(), ih[:m])
        np.testing.assert_array_equal(key2, np.where(ip[:m] >= 0, 0, 0xFFFFFFFF))
        assert (ip[m:] == -1).all()
    assert m == 0 and b == 3   # the last block lies past the pg


@pytest.mark.parametrize("n_verify", [6, 1])
def test_wide_probe_matches_build_probe_fn(pg_case, n_verify):
    """Kernels C and A with int64 positions (the wide probe of pgs past 2^31
    symbols) against `_build_probe_fn(..., wide=True)`, on an index cut into
    two blocks; each block's result alone, as the merge takes them."""
    pg, reads = pg_case
    k = 32
    index = ref_matcher.build_index(pg, k=k, device_sort=True)
    blocks, pg_lanes, wpf, i_pad = ref_matcher.device_index(index, pg, wide=True,
                                                            max_block=10_000)
    assert len(blocks) == 2
    offs = ref_matcher.probe_offsets(L, k, 3)
    lanes, _ = ref_packed.pack_lanes(reads)
    fn = ref_matcher._build_probe_fn(R, L, offs, k, i_pad, wpf, 33, wide=True,
                                     n_verify=n_verify)
    for ihash, ipos in blocks:
        ihash, ipos = np.asarray(ihash), np.asarray(ipos)
        assert ipos.dtype == np.int64
        mis_r, pos_r = jax.device_get(fn(jnp.asarray(lanes), jnp.asarray(ihash),
                                         jnp.asarray(ipos), pg_lanes, index.pg_len))
        ih_t, ip_t = state.index_to_device(ihash, ipos, "cpu", wide=True)
        mis, pos = port_matcher.probe(
            uint.np_u32_to_tensor(lanes, "cpu"), offs,
            _key_buffer(ih_t, ip_t, R * len(offs)), ip_t,
            uint.np_u32_to_tensor(np.asarray(pg_lanes), "cpu"), index.pg_len, L, k, 33,
            n_verify)
        assert pos.dtype == torch.int64
        np.testing.assert_array_equal(mis.numpy(), mis_r)
        np.testing.assert_array_equal(pos.numpy(), pos_r)
        assert 0 < (mis_r != 255).mean() < 0.75


@pytest.mark.parametrize("k", [32, 24, 37])
def test_probe_hash_matches_window_hashes(pg_case, k):
    """Kernel C, in its key form: the hash in the key's high word at every
    probe offset equals the reference's k-window hash of the read, and
    key2 = 1 + r*S + j."""
    _, reads = pg_case
    offs = ref_matcher.probe_offsets(L, k, 3)
    lanes, _ = ref_packed.pack_lanes(reads)
    h, key2 = _split_keys(kmer_hash.probe_kmer_hash_plain(
        uint.np_u32_to_tensor(lanes, "cpu"), offs, k))
    want = np.stack([ref_matcher._window_hashes(r, k)[list(offs)] for r in reads])
    np.testing.assert_array_equal(h.reshape(want.shape), want)
    np.testing.assert_array_equal(key2, 1 + np.arange(want.size))


def roll_rounds(with_n, act, seed):
    """Kernel D's plain version over rounds 1..6 against the reference's
    round arithmetic in numpy (`_pow_table64`, the inverse bases) and its
    entries k1 = [p if active_p else INV64, h if active_s else INV64]: the
    entries the round's sort keeps are the valid ones of k1, in (side, gid)
    order. -> the entry counts m of the rounds."""
    rng = np.random.default_rng(seed)
    n = 500
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    if with_n:
        codes[rng.random((n, L)) < 0.02] = 4
    v = codes.astype(np.uint64)
    a_s = rng.random(n) < act
    a_p = rng.random(n) < act
    hs = [rng.integers(0, 2**64, n, dtype=np.uint64) for _ in range(4)]
    lanes, nmask = state.sweep_lanes_to_device(*ref_packed.pack_lanes(codes), "cpu")
    assert (nmask is not None) == with_n
    ts = [state.hashes_to_device(h.copy(), "cpu") for h in hs]
    keys, ent, scratch = sweep.round_buffers(n, "cpu")
    pa, pb = ref_scs._pow_table64(L), ref_scs._pow_table64(L, ref_scs.HASH_BASE64B)
    h, p, h2, p2 = hs
    INV64 = np.uint64(2**64 - 1)
    counts = []
    with np.errstate(over="ignore"):
        for i in range(1, 7):
            h = h - v[:, i - 1] * pa[L - i]
            h2 = h2 - v[:, i - 1] * pb[L - i]
            p = (p - v[:, L - i]) * ref_scs.HASH_BASE64_INV
            p2 = (p2 - v[:, L - i]) * ref_scs.HASH_BASE64B_INV
            count = sweep.sweep_roll_entries(
                lanes, nmask, torch.from_numpy(a_s), torch.from_numpy(a_p), i, L, *ts,
                keys, ent, scratch)
            k1 = np.concatenate([np.where(a_p, p, INV64), np.where(a_s, h, INV64)])
            valid = np.concatenate([a_p, a_s])
            m = int(count)
            assert count.shape == (1,) and m == valid.sum()
            np.testing.assert_array_equal(ent[:m].numpy(), np.nonzero(valid)[0])
            np.testing.assert_array_equal(
                uint.tensor_to_np_u64(uint.from_order_key64(keys[:m])), k1[valid])
            for t, want in zip(ts, (h, p, h2, p2)):
                np.testing.assert_array_equal(uint.tensor_to_np_u64(t), want)
            counts.append(m)
    return counts


@pytest.mark.parametrize("with_n", [False, True])
def test_sweep_roll_entries_matches_reference_rounds(with_n):
    """Kernel D: rounds 1..6 of roll, active entries and their count."""
    counts = roll_rounds(with_n, 0.7, 7 + with_n)
    assert all(0 < m < 1000 for m in counts)


@pytest.mark.parametrize("act", [0.0, 1.0])
def test_sweep_roll_entries_at_no_and_all_active(act):
    """Kernel D with no active entry (m = 0: the hashes still roll) and with
    every entry active (m = 2n)."""
    assert roll_rounds(True, act, 9) == [int(act * 1000)] * 6


@pytest.mark.parametrize("L_rc,with_n", [(100, False), (100, True), (80, True), (37, True)])
def test_revcomp_lanes_matches_reference(L_rc, with_n):
    """The matcher's reverse-complement prep (K8) against packed.revcomp_lanes."""
    rng = np.random.default_rng(L_rc)
    codes = rng.integers(0, 4, size=(200, L_rc), dtype=np.uint8)
    if with_n:
        codes[rng.random(codes.shape) < 0.03] = 4
    lanes, nmask = ref_packed.pack_lanes(codes)
    want = ref_packed.revcomp_lanes(lanes, L_rc, nmask)
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    got = uint.tensor_to_np_u32(port_packed.revcomp_lanes(lt, L_rc, nt))
    np.testing.assert_array_equal(got, want)


STRAND_LENGTHS = [16, 17, 31, 32, 33, 37, 63, 64, 65, 80, 100, 128, 129, 200, 255]
STRAND_N = ["no nmask", "N in 3%", "rows all N", "N first and last"]
STRAND_ROWS = ["every row", "shuffled with repeats", "one row"]


def _strand_case(L_, n_case, rows_case):
    """Reads of length L_ (pack_lanes layout, reference packer) with N as
    `n_case` says, and the rows a take asks for (None = every row)."""
    rng = np.random.default_rng(1000 * L_ + 10 * STRAND_N.index(n_case)
                                + STRAND_ROWS.index(rows_case))
    n = 97
    codes = rng.integers(0, 4, size=(n, L_), dtype=np.uint8)
    if n_case == "N in 3%":
        codes[rng.random(codes.shape) < 0.03] = 4
    elif n_case == "rows all N":
        codes[::5] = 4
    elif n_case == "N first and last":
        codes[::3, 0] = 4
        codes[1::3, -1] = 4
    lanes, nmask = ref_packed.pack_lanes(codes)
    assert (nmask is None) == (n_case == "no nmask")
    rows = {"every row": None, "one row": np.array([n - 2]),
            "shuffled with repeats": rng.permutation(
                np.concatenate([rng.choice(n, 40, replace=False), [5, 5, 17]]))}[rows_case]
    return lanes, nmask, rows


@pytest.mark.parametrize("rows_case", STRAND_ROWS)
@pytest.mark.parametrize("n_case", STRAND_N)
@pytest.mark.parametrize("L_", STRAND_LENGTHS)
def test_strand_rows_plain_matches_revcomp_and_take(L_, n_case, rows_case):
    """Kernel I's plain version (K8's strand prep, K9's row take) against
    the reference's packed.revcomp_lanes plus np.take: [rows; their reverse
    complements], N groups cleared to A, at every lane count and tail, and
    its CPU wrapper the same."""
    lanes, nmask, rows = _strand_case(L_, n_case, rows_case)
    take = np.arange(lanes.shape[0]) if rows is None else rows
    rc = ref_packed.revcomp_lanes(lanes, L_, nmask)
    want = np.concatenate([np.take(lanes, take, axis=0), np.take(rc, take, axis=0)])
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    rows_t = None if rows is None else torch.from_numpy(rows.astype(np.int64))
    got = strand_rows.strand_rows_plain(lt, nt, L_, rows_t)
    np.testing.assert_array_equal(uint.tensor_to_np_u32(got), want)
    assert torch.equal(strand_rows.strand_rows(lt, nt, L_, rows_t), got)


def test_strand_rows_checks_its_inputs():
    """The wrapper refuses what kernel I does not take, on the CPU as on the
    card: a lane count that is not L's, an N mask of another width, int32
    row ids, rows that are not contiguous, a read longer than 16 lanes."""
    lanes, nmask, _ = _strand_case(100, "N in 3%", "every row")
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    with pytest.raises(ValueError, match="shape"):
        strand_rows.strand_rows(lt, nt, 80)
    with pytest.raises(ValueError, match="shape"):
        strand_rows.strand_rows(lt, nt[:, :4].contiguous(), 100)
    with pytest.raises(TypeError):
        strand_rows.strand_rows(lt, nt, 100, torch.arange(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        strand_rows.strand_rows(lt, nt, 100, torch.arange(6)[::2])
    with pytest.raises(ValueError, match="lanes per read"):
        strand_rows.strand_rows(torch.zeros((4, 18), dtype=torch.int32), None, 257)


def test_two_pass_takes_its_rows_through_kernel_i(monkeypatch):
    """-l 2 on reads of both strands with N: pass 1's rows and pass 2's take
    both come from strand_rows (the prep form, then the take form with the
    reads pass 1 did not accept), each bit-equal to the reference's
    revcomp_lanes rows, and the match equals the reference's on both
    strands."""
    rng = np.random.default_rng(21)
    pg = rng.integers(0, 4, size=30_011, dtype=np.uint8)
    n = 600
    starts = rng.integers(0, pg.size - L, n)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    err = rng.random(reads.shape) < 0.03
    reads[err] = (reads[err] + 1) % 4
    flip = rng.random(n) < 0.5
    reads[flip] = ref_packed.revcomp_codes_matrix(reads[flip])
    reads[::13, 40] = 4
    calls = []
    real = port_matcher.strand_rows

    def spy(lanes, nmask, L_, rows=None):
        out = real(lanes, nmask, L_, rows)
        calls.append((None if rows is None else rows.numpy().copy(), out.clone()))
        return out

    monkeypatch.setattr(port_matcher, "strand_rows", spy)
    index = ref_matcher.build_index(pg, k=32, device_sort=True)
    a = ref_matcher.match_reads(reads, index, pg, max_mismatches=33, accept_mis=2)
    b = port_matcher.match_reads(reads, index, pg, max_mismatches=33, accept_mis=2,
                                 device="cpu")
    for field in ("pos", "rc", "mis"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.rc.any() and (~a.rc & (a.pos >= 0)).any()
    assert [c[0] is None for c in calls] == [True, False]
    lanes, nmask = ref_packed.pack_lanes(reads)
    rc = ref_packed.revcomp_lanes(lanes, L, nmask)
    take = calls[1][0]
    assert 0 < take.size < n
    np.testing.assert_array_equal(uint.tensor_to_np_u32(calls[0][1]),
                                  np.concatenate([lanes, rc]))
    np.testing.assert_array_equal(uint.tensor_to_np_u32(calls[1][1]),
                                  np.concatenate([lanes[take], rc[take]]))


def test_join_keys_sort_as_hash_then_key2():
    """The composed key's signed order is the reference's (hash, key2) order
    (matcher.py:228-238), over hashes at both ends of the u32 range, inert
    and live index entries and probes of equal hashes."""
    rng = np.random.default_rng(3)
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF],
                    np.uint32)
    ihash = rng.choice(vals, 500)
    ipos = np.where(rng.random(500) < 0.3, -1, rng.integers(0, 1 << 20, 500))
    hashes = rng.choice(vals, (40, 7))
    ih_t = torch.from_numpy(ihash.view(np.int32).copy())
    keys = torch.cat([kmer_hash.index_keys(ih_t, torch.from_numpy(ipos.astype(np.int32))),
                      kmer_hash.probe_keys(torch.from_numpy(hashes.view(np.int32).copy()))])
    h = np.concatenate([ihash, hashes.ravel()]).astype(np.int64)
    key2 = np.concatenate([np.where(ipos >= 0, 0, 0xFFFFFFFF), 1 + np.arange(hashes.size)])
    got = _split_keys(torch.sort(keys).values)
    order = np.lexsort((key2, h))
    np.testing.assert_array_equal(got[0], h[order])
    np.testing.assert_array_equal(got[1], key2[order])
    np.testing.assert_array_equal(_split_keys(keys)[0], h)


def test_kmer_hash_wrappers_fill_one_key_buffer(pg_case):
    """B writes a join buffer's head and C its tail, in place, as the
    matcher's pass does; what lands there equals the plain versions; the
    wrappers refuse what the kernels do not take."""
    pg, reads = pg_case
    k, k1 = 37, 4
    pg_t = state.pg_lanes_to_device(pg, "cpu")
    lanes = uint.np_u32_to_tensor(ref_packed.pack_lanes(reads[:50])[0], "cpu")
    offs = ref_matcher.probe_offsets(L, k, 3)
    m, P = 3000, 50 * len(offs)
    buf = torch.zeros(m + P + 9, dtype=torch.int64)
    ipos_buf = torch.zeros(m + 4, dtype=torch.int32)
    key, ipos = kmer_hash.index_kmer_hash(pg_t, k, k1, pg.size, m, 7, False,
                                          buf[:m], ipos_buf[:m])
    tail = kmer_hash.probe_kmer_hash(lanes, offs, k, buf[m:m + P])
    assert key.data_ptr() == buf.data_ptr() and tail.data_ptr() == buf[m:].data_ptr()
    want_key, want_pos = kmer_hash.index_kmer_hash_plain(pg_t, k, k1, pg.size, m, 7)
    np.testing.assert_array_equal(buf[:m].numpy(), want_key.numpy())
    np.testing.assert_array_equal(ipos.numpy(), want_pos.numpy())
    np.testing.assert_array_equal(buf[m:m + P].numpy(),
                                  kmer_hash.probe_kmer_hash_plain(lanes, offs, k).numpy())
    assert (buf[m + P:] == 0).all() and (ipos_buf[m:] == 0).all()
    with pytest.raises(ValueError, match="k1"):
        kmer_hash.index_kmer_hash(pg_t, k, 3, pg.size, m)
    with pytest.raises(TypeError):
        kmer_hash.index_kmer_hash(pg_t, k, k1, pg.size, m, 0, True, buf[:m], ipos_buf[:m])
    with pytest.raises(ValueError):
        kmer_hash.probe_kmer_hash(lanes, offs, k, buf[:P - 1])
    with pytest.raises(ValueError, match="past the read lanes"):
        kmer_hash.probe_kmer_hash(lanes, tuple(o + 100 for o in offs), k)


def test_offsets_tensor_is_made_once_per_offsets_and_device():
    """Kernels C and A of a probe read one cached offsets tensor: a second
    call returns the same object, and other offsets another one."""
    offs = (0, 3, 6, 9)
    a = kmer_hash.offsets_tensor(offs, torch.device("cpu"))
    assert kmer_hash.offsets_tensor(offs, torch.zeros(1).device) is a
    assert a.dtype == torch.int32 and a.tolist() == list(offs)
    assert kmer_hash.offsets_tensor((0, 3), torch.device("cpu")) is not a


ANCHOR_CASES = ("mixed", "S 69", "pg_len < L")


def _anchor_case(case, wide):
    """Reads (planted in a pg with ~3% substitutions where the pg is long
    enough), their probe offsets and hashes, and the join's anchors [R, S]
    (position + 1, 0 = none) chosen per slot: none, a start below 0, a
    start past pg_len - L, or a start in range within 2 of the read's own.
    int32 positions stay below 2^31, int64 ones reach past it."""
    rng = np.random.default_rng(ANCHOR_CASES.index(case) + 10 * wide)
    k, n = 32, 200
    pg_len = 60 if case == "pg_len < L" else 20_011
    pg = rng.integers(0, 4, size=pg_len, dtype=np.uint8)
    offs = tuple(range(0, L - k + 1, 1 if case == "S 69" else 3))
    if pg_len >= L:
        near = rng.integers(0, pg_len - L + 1, n)
        reads = pg[near[:, None] + np.arange(L)[None, :]].copy()
        err = rng.random(reads.shape) < 0.03
        reads[err] = (reads[err] + 1) % 4
    else:
        near = np.zeros(n, np.int64)
        reads = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    off = np.asarray(offs, np.int64)[None, :]
    kind = rng.integers(0, 4, size=(n, len(offs)))
    kind[:, 0] = 3                       # every row has one in-range anchor
    kind[: n // 10] = 0                  # and a tenth of the rows none at all
    hi = max(pg_len - L, 0)
    st = np.clip(near[:, None] + rng.integers(-2, 3, size=kind.shape), 0, hi)
    pos = np.where(kind == 3, st + off, 0)
    pos = np.where(kind == 1, rng.integers(0, 1 << 20, size=kind.shape) % np.maximum(off, 1), pos)
    pos = np.where(kind == 2, pg_len - L + off + 1 + rng.integers(
        0, (1 << 33) if wide else 1000, size=kind.shape), pos)
    kind = np.where((kind == 1) & (off == 0), 0, kind)
    res = np.where(kind == 0, 0, pos + 1)
    return pg, reads, offs, res, kind


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("case", ANCHOR_CASES)
def test_probe_starts_plain_is_the_old_composition(case, wide):
    """Kernel A's plain path (probe_starts_plain, then the unchanged
    verify_best_plain) and its CPU wrapper against the probe's old
    epilogue (matcher.probe before kernel A read the anchors) on anchors
    with zeros, starts below 0 and past pg_len - L, pg_len < L, S > 64."""
    pg, reads, offs, res, kind = _anchor_case(case, wide)
    lanes = uint.np_u32_to_tensor(ref_packed.pack_lanes(reads)[0], "cpu")
    pg_t = state.pg_lanes_to_device(pg, "cpu")
    res_t = torch.from_numpy(res)
    start_all = res_t - 1 - torch.tensor(offs, dtype=torch.int64)[None, :]
    in_range = (res_t > 0) & (start_all >= 0) & (start_all <= pg.size - L)
    if not wide:
        start_all = start_all.to(torch.int32)
    got_st, got_in = verify.probe_starts_plain(res_t, offs, pg.size, L, wide)
    assert got_st.dtype == start_all.dtype and torch.equal(got_st, start_all)
    assert torch.equal(got_in, in_range)
    np.testing.assert_array_equal(in_range.numpy(), (kind == 3) & (pg.size >= L))
    for n_verify in (6, 1):
        want = verify.verify_best_plain(lanes, start_all, in_range, pg_t, max(pg.size - L, 0),
                                        L, 33, n_verify)
        got = verify.verify_best(lanes, res_t, offs, pg_t, pg.size, L, 33, n_verify, wide)
        assert got[1].dtype == (torch.int64 if wide else torch.int32)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert ((want[0] != 255).sum() > 0) == (pg.size >= L)


@pytest.mark.parametrize("lead", [1, 2, 3])
def test_verify_best_refuses_a_pg_off_16_bytes(lead):
    """Kernel A reads the pg in aligned 16-byte chunks, so verify_best
    refuses pg lanes that start 4, 8 or 12 bytes past 16 (an offset view),
    on the CPU as on the card, and takes the same lanes copied to a tensor
    of their own."""
    pg, reads, offs, res, _ = _anchor_case("mixed", False)
    lanes = uint.np_u32_to_tensor(ref_packed.pack_lanes(reads)[0], "cpu")
    pg_t = state.pg_lanes_to_device(pg, "cpu")
    buf = torch.zeros(pg_t.numel() + 8, dtype=torch.int32)
    skip = (-buf.data_ptr() // 4) % 4                 # lanes to the first 16 bytes
    view = buf[skip + lead: skip + lead + pg_t.numel()]
    view.copy_(pg_t)
    assert view.data_ptr() % 16 == 4 * lead
    args = (torch.from_numpy(res), offs)
    with pytest.raises(ValueError, match="16 bytes"):
        verify.verify_best(lanes, *args, view, pg.size, L, 33, 6, False)
    got = verify.verify_best(lanes, *args, view.clone(), pg.size, L, 33, 6, False)
    want = verify.verify_best(lanes, *args, pg_t, pg.size, L, 33, 6, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_verify", [6, 1])
@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("case", ANCHOR_CASES)
def test_probe_from_anchors_matches_make_probe(case, wide, n_verify):
    """The port's probe (C, the join, then A from the anchors) against the
    reference's `_make_probe` on an index made so that the join hands each
    probe a chosen anchor: none, a start below 0, a start past pg_len - L,
    or one in range; pg_len < L and S 69 (more slots than a 64-bit mask)
    included, int32 and int64 positions."""
    pg, reads, offs, res, kind = _anchor_case(case, wide)
    k = 32
    hashes = np.stack([ref_matcher._window_hashes(r, k)[list(offs)] for r in reads])
    has = kind != 0
    ihash = np.concatenate([hashes[has], np.zeros(7, np.uint32)]).astype(np.uint32)
    ipos = np.concatenate([res[has] - 1, np.full(7, -1)]).astype(np.int64 if wide else np.int32)
    lanes, _ = ref_packed.pack_lanes(reads)
    pg_lanes = uint.tensor_to_np_u32(state.pg_lanes_to_device(pg, "cpu"))
    n = reads.shape[0]
    fn = jax.jit(ref_matcher._make_probe(n, L, offs, k, ipos.size, pg_lanes.size, 33, wide=wide,
                                         n_verify=n_verify))
    mis_r, pos_r = jax.device_get(fn(jnp.asarray(lanes), jnp.asarray(ihash), jnp.asarray(ipos),
                                     jnp.asarray(pg_lanes), pg.size))
    ih_t, ip_t = state.index_to_device(ihash, ipos, "cpu", wide=wide)
    mis, pos = port_matcher.probe(
        uint.np_u32_to_tensor(lanes, "cpu"), offs, _key_buffer(ih_t, ip_t, n * len(offs)), ip_t,
        uint.np_u32_to_tensor(pg_lanes, "cpu"), pg.size, L, k, 33, n_verify)
    assert pos.dtype == (torch.int64 if wide else torch.int32)
    np.testing.assert_array_equal(mis.numpy(), mis_r)
    np.testing.assert_array_equal(pos.numpy(), pos_r)
    if pg.size >= L:   # one verified start in 5 is the read's own at n_verify 1
        assert (0.3 if n_verify > 1 else 0.1) < (mis_r != 255).mean() < 0.95
    else:
        assert (mis_r == 255).all()


def sharded_round_entries(shards, counts):
    """The gathered side of a sharded round, as greedy_scs._round_sharded
    builds it from the shards' send buffers and counts after kernel D's
    sharded form: the gathered heads (the gather: every shard's first
    chunks, as many as the largest count needs), the key layout and its
    stable sort. -> (ks, perm, gathered, counts)."""
    from pgrc_tpu_torch.kernels import sweep_pair_claim

    chunks = sweep.record_chunks(max(c[0] for c in counts))
    gathered = torch.stack([s["bufs"][0][:chunks] for s in shards])
    counts = torch.tensor(counts, dtype=torch.int64)
    keys = sweep_pair_claim.sharded_keys(gathered, counts, int(counts[:, 0].sum()))
    ks, perm = torch.sort(keys, stable=True)
    return ks, perm, gathered, counts


def sharded_rounds(codes, a_s, a_p, ranks, rounds):
    """Rounds 1..rounds of a sweep table over `ranks` simulated shards with
    the plain sharded forms of kernels D and F and the key layout (each
    shard a contiguous block of rows with its own flags, its own replica of
    the links and its own send buffer, sized from the largest shard; the
    round as greedy_scs._round_sharded runs it: the shards' heads gathered,
    the keys laid out in (side, rank) order and sorted stably, F reading
    each entry through the permutation), against the one-device plain D and
    F on the whole table: after every round each replica's links equal the
    one-device links, and the shards' flags and hashes, in shard order, the
    one-device ones. -> the total entries per round."""
    from pgrc_tpu_torch.kernels import sweep_init, sweep_pair_claim
    from pgrc_tpu_torch.overlap import greedy_scs as port_scs

    n, L_ = codes.shape
    lanes, nmask = state.sweep_lanes_to_device(*ref_packed.pack_lanes(codes), "cpu")
    h0, h0b = sweep_init.sweep_full_hashes(lanes, nmask, L_)
    one = dict(h=h0.clone(), p=h0.clone(), h2=h0b.clone(), p2=h0b.clone(),
               a_s=torch.from_numpy(a_s.copy()), a_p=torch.from_numpy(a_p.copy()),
               succ=torch.full((n,), -1, dtype=torch.int32), ovl=torch.zeros(n, dtype=torch.int32))
    base, extra = divmod(n, ranks)
    sizes = [base + (r < extra) for r in range(ranks)]
    shards = []
    for r in range(ranks):
        lo = sum(sizes[:r])
        hi = lo + sizes[r]
        shards.append(dict(
            lo=lo, hi=hi, lanes=port_packed.cols_copy(lanes[:, lo:hi]),
            nmask=None if nmask is None else port_packed.cols_copy(nmask[:, lo:hi]),
            ids=torch.arange(lo, hi, dtype=torch.int32),
            **{k: one[k][lo:hi].clone() for k in ("h", "p", "h2", "p2", "a_s", "a_p")},
            succ=one["succ"].clone(), ovl=one["ovl"].clone(),
            bufs=sweep.record_buffers(max(sizes), "cpu")))
    keys, ent, scratch = sweep.round_buffers(n, "cpu")
    totals = []
    for i in range(1, rounds + 1):
        count = sweep.sweep_roll_entries(lanes, nmask, one["a_s"], one["a_p"], i, L_, one["h"],
                                         one["p"], one["h2"], one["p2"], keys, ent, scratch)
        order = port_scs.round_order(keys, ent, count)
        if order is not None:
            sweep_pair_claim.sweep_pair_claim(*order, torch.arange(n, dtype=torch.int32),
                                              one["p2"], one["h2"], one["succ"], one["ovl"],
                                              one["a_s"], one["a_p"], i, L_)
        counts = [sweep.sweep_roll_records(
            s["lanes"], s["nmask"], s["a_s"], s["a_p"], i, L_, s["h"], s["p"], s["h2"],
            s["p2"], s["ids"], *s["bufs"]).tolist() for s in shards]
        ks, perm, gathered, counts = sharded_round_entries(shards, counts)
        totals.append(ks.numel())
        for s in shards:
            sweep_pair_claim.sweep_pair_records(ks, perm, gathered, counts, s["succ"], s["ovl"],
                                                s["a_s"], s["a_p"], s["lo"], s["hi"], i, L_)
        for s in shards:
            assert torch.equal(s["succ"], one["succ"]) and torch.equal(s["ovl"], one["ovl"])
        for k in ("h", "p", "h2", "p2", "a_s", "a_p"):
            assert torch.equal(torch.cat([s[k] for s in shards]), one[k]), (i, k)
    assert (one["succ"] >= 0).any()
    return totals


def _sharded_case(case):
    """(codes, a_s, a_p, ranks) of the sharded round's edge cases: the ones
    chip_smoke's mesh phase runs on the card."""
    rng = np.random.default_rng(31)
    genome = rng.integers(0, 4, size=2000, dtype=np.uint8)
    L_ = 40
    if case == "a rank with no rows":
        codes, ranks = np.stack([genome[s:s + L_] for s in (20, 0, 10)]), 4
    elif case in ("n not divisible by the ranks", "a rank with no active prefix",
                  "a rank with no active suffix"):
        st = rng.integers(0, genome.size - L_, size=1001)
        codes, ranks = genome[st[:, None] + np.arange(L_)], 4
    elif case == "send buffers filled to their last word":   # 4 ranks of 2 chunks' rows
        st = rng.integers(0, genome.size - L_, size=8 * sweep.CHUNK)
        codes, ranks = genome[st[:, None] + np.arange(L_)], 4
    elif case == "an equal-hash run across ranks":
        base = np.stack([genome[s:s + L_] for s in range(6)])
        codes, ranks = base[rng.permutation(np.repeat(np.arange(6), 40))], 4
    else:  # every entry on one rank: only the rows of rank 2's block active
        st = rng.integers(0, 200, size=400)
        codes, ranks = genome[st[:, None] + np.arange(L_)], 4
    n = codes.shape[0]
    a_s, a_p = np.ones(n, dtype=bool), np.ones(n, dtype=bool)
    if case == "every entry on one rank":
        a_s[:] = a_p[:] = False
        a_s[200:300] = a_p[200:300] = True
    elif case == "a rank with no active prefix":   # rank 1's rows: suffixes only
        a_p[251:501] = False
    elif case == "a rank with no active suffix":   # rank 2's rows: prefixes only
        a_s[501:751] = False
    return codes, a_s, a_p, ranks


SHARDED_CASES = ("a rank with no rows", "n not divisible by the ranks",
                 "an equal-hash run across ranks", "every entry on one rank",
                 "a rank with no active prefix", "a rank with no active suffix",
                 "send buffers filled to their last word")


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_sharded_d_and_f_plain_match_one_device(case):
    """Kernels D's and F's sharded forms and the key layout (plain
    versions) over simulated shards give the one-device plain D + F's
    links, flags and hashes, round after round (39 rounds at L 40)."""
    codes, a_s, a_p, ranks = _sharded_case(case)
    totals = sharded_rounds(codes, a_s, a_p, ranks, codes.shape[1] - 1)
    assert totals[0] > 0


def test_sharded_records_pack_side_gid_row():
    """Kernel D's sharded form writes each active entry d, prefixes (in row
    order) before suffixes, in chunks of CHUNK: its key (hash ^ SIGN64) at
    word d // CHUNK * CHUNK_WORDS + d % CHUNK, its record side | gid | row
    and its confirm hash at the chunk's payload words CHUNK + 2 (d % CHUNK)
    and the one after; it counts both sides; the words past the entries are
    left as they were."""
    n = 40
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    lanes, nmask = state.sweep_lanes_to_device(*ref_packed.pack_lanes(codes), "cpu")
    hs = [torch.arange(n, dtype=torch.int64) * (k + 1) + 7 for k in range(4)]
    a_s = torch.from_numpy(rng.random(n) < 0.6)
    a_p = torch.from_numpy(rng.random(n) < 0.6)
    ids = torch.arange(100, 100 + n, dtype=torch.int32)
    recs, scratch = sweep.record_buffers(n, "cpu")
    assert tuple(recs.shape) == (-(-2 * n // sweep.CHUNK), sweep.CHUNK_WORDS)
    recs.fill_(-5)
    h, p, h2, p2 = (t.clone() for t in hs)
    counts = sweep.sweep_roll_records(lanes, nmask, a_s, a_p, 1, L, h, p, h2, p2, ids, recs,
                                      scratch)
    pre = [r for r in range(n) if a_p[r]]
    suf = [r for r in range(n) if a_s[r]]
    assert counts.tolist() == [len(pre) + len(suf), len(pre)]
    flat = recs.view(-1).tolist()
    entries = [(0, r, p[r], p2[r]) for r in pre] + [(1, r, h[r], h2[r]) for r in suf]
    assert len(entries) > sweep.CHUNK    # the entries span chunks
    for d, (side, r, key, conf) in enumerate(entries):
        chunk, k = divmod(d, sweep.CHUNK)
        base = chunk * sweep.CHUNK_WORDS
        assert flat[base + k] == int(key) ^ uint.SIGN64
        assert flat[base + sweep.CHUNK + 2 * k] == (side << 62) | ((100 + r) << 31) | r
        assert flat[base + sweep.CHUNK + 2 * k + 1] == int(conf)
    written = {w for d in range(len(entries)) for w in (
        d // sweep.CHUNK * sweep.CHUNK_WORDS + d % sweep.CHUNK,
        d // sweep.CHUNK * sweep.CHUNK_WORDS + sweep.CHUNK + 2 * (d % sweep.CHUNK),
        d // sweep.CHUNK * sweep.CHUNK_WORDS + sweep.CHUNK + 2 * (d % sweep.CHUNK) + 1)}
    assert all(v == -5 for w, v in enumerate(flat) if w not in written)


@pytest.mark.parametrize("counts", [[(9, 4)], [(3, 1), (0, 0), (70, 33)],
                                    [(5, 5), (2, 0), (0, 0), (40, 17)]],
                         ids=["1 rank", "3 ranks", "4 ranks"])
def test_sharded_position_map(counts):
    """F's position map (a position in (side, rank) order -> its rank and
    its row in that rank's send buffer) against the order written out: every
    rank's prefixes in rank order, then every rank's suffixes, a rank's
    suffixes after its prefixes in its buffer; uneven counts, ranks with no
    entry, no prefix or no suffix."""
    from pgrc_tpu_torch.kernels import sweep_pair_claim

    want = [(r, d) for r, (m, mp) in enumerate(counts) for d in range(mp)]
    want += [(r, d) for r, (m, mp) in enumerate(counts) for d in range(mp, m)]
    counts = torch.tensor(counts, dtype=torch.int64)
    table = sweep_pair_claim.record_table(counts).tolist()
    assert table[-1] == len(want) and table[counts.shape[0]] == int(counts[:, 1].sum())
    r, d = sweep_pair_claim.gathered_rows(counts, torch.arange(len(want)))
    assert list(zip(r.tolist(), d.tolist())) == want


def test_sharded_layout_rank_with_no_entries():
    """A rank with no row sends counts (0, 0) and its buffer's head; the key
    layout skips it (and the chunks past every rank's count), and F's
    sharded form pairs the other ranks' entries as if it were not there."""
    from pgrc_tpu_torch.kernels import sweep_init, sweep_pair_claim

    rng = np.random.default_rng(8)
    genome = rng.integers(0, 4, size=300, dtype=np.uint8)
    codes = np.stack([genome[s:s + L] for s in rng.integers(0, 200, size=70)])
    lanes, nmask = state.sweep_lanes_to_device(*ref_packed.pack_lanes(codes), "cpu")
    h0, h0b = sweep_init.sweep_full_hashes(lanes, nmask, L)
    blocks = ((0, 0), (0, 30), (30, 70))     # rank 0 holds no row
    shards, counts = [], []
    for lo, hi in blocks:
        s = dict(lo=lo, hi=hi, bufs=sweep.record_buffers(40, "cpu"),
                 hs=[h0[lo:hi].clone(), h0[lo:hi].clone(), h0b[lo:hi].clone(),
                     h0b[lo:hi].clone()], a_s=torch.ones(hi - lo, dtype=torch.bool),
                 a_p=torch.ones(hi - lo, dtype=torch.bool))
        s["bufs"][0].fill_(-1)
        counts.append(sweep.sweep_roll_records(
            lanes[:, lo:hi], None if nmask is None else nmask[:, lo:hi], s["a_s"], s["a_p"], 1, L,
            *s["hs"], torch.arange(lo, hi, dtype=torch.int32), *s["bufs"]).tolist())
        shards.append(s)
    assert counts == [[0, 0], [60, 30], [80, 40]]
    ks, perm, gathered, counts = sharded_round_entries(shards, counts)
    assert gathered.shape[1] == sweep.record_chunks(80)
    assert sweep_pair_claim.record_table(counts).tolist() == [0, 0, 30, 70, 70, 100, 140]
    rolled = [s["hs"] for s in shards]
    want = torch.cat([rolled[1][1], rolled[2][1], rolled[1][0], rolled[2][0]]) ^ uint.SIGN64
    assert torch.equal(ks, torch.sort(want, stable=True).values)
    assert torch.equal(sweep_pair_claim.sharded_keys(gathered, counts, 140)[perm], ks)
    # F over the gathered entries of ranks 1 and 2 against one table of rows 0-69
    succ, ovl = torch.full((70,), -1, dtype=torch.int32), torch.zeros(70, dtype=torch.int32)
    flags = [torch.ones(70, dtype=torch.bool) for _ in range(2)]
    for s in shards:
        sweep_pair_claim.sweep_pair_records(ks, perm, gathered, counts, succ, ovl,
                                            s["a_s"], s["a_p"], s["lo"], s["hi"], 1, L)
    h, p, h2, p2 = (torch.cat([rolled[1][k], rolled[2][k]]) for k in range(4))
    keys = torch.cat([p, h]) ^ uint.SIGN64
    ks1, order = torch.sort(keys, stable=True)
    succ1, ovl1 = torch.full((70,), -1, dtype=torch.int32), torch.zeros(70, dtype=torch.int32)
    sweep_pair_claim.sweep_pair_claim(ks1, order, torch.arange(70, dtype=torch.int32), p2, h2,
                                      succ1, ovl1, *flags, 1, L)
    assert torch.equal(succ, succ1) and torch.equal(ovl, ovl1) and (succ >= 0).any()
    assert torch.equal(torch.cat([s["a_s"] for s in shards]), flags[0])
    assert torch.equal(torch.cat([s["a_p"] for s in shards]), flags[1])
