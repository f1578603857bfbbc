"""The port's device sweep against the reference's (both forced past their
numpy mirror with _HOST_SWEEP_MAX = 0): identical links, bit for bit."""
import numpy as np
import pytest
import torch

from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu.overlap import greedy_scs as ref
from pgrc_tpu_torch import state
from pgrc_tpu_torch.kernels import sweep_compact, sweep_init
from pgrc_tpu_torch.overlap import greedy_scs as port
from pgrc_tpu_torch.utils import uint
from test_overlap import sample_genome_reads

N_READS, L = 2500, 100   # one padded shape (3072 rows) for every reference call


@pytest.fixture(autouse=True)
def device_sweep_both(monkeypatch):
    monkeypatch.setattr(ref, "_HOST_SWEEP_MAX", 0)
    monkeypatch.setattr(port, "_HOST_SWEEP_MAX", 0)


def reads(seed, n_frac=0.0, dup_frac=0.05):
    """Genome reads at ~10x, a few exact duplicates, N in a fraction of rows."""
    codes = sample_genome_reads(N_READS, L, 25_000, seed=seed)
    rng = np.random.default_rng(seed)
    dup = np.nonzero(rng.random(N_READS) < dup_frac)[0]
    codes[dup] = codes[rng.integers(0, N_READS, dup.size)]
    rows = np.nonzero(rng.random(N_READS) < n_frac)[0]
    codes[rows, rng.integers(0, L, rows.size)] = 4
    return codes


def assert_same_links(a, b):
    np.testing.assert_array_equal(a.succ, b.succ)
    np.testing.assert_array_equal(a.overlap, b.overlap)
    assert (a.succ >= 0).sum() > N_READS // 2


@pytest.mark.parametrize("seed,coef,n_frac", [
    (1, 1.0, 0.0), (2, 1.0, 0.0), (3, 1.0, 0.0),   # three seeds
    (4, 1.0, 0.05),                                # reads with N
    (5, 0.65, 0.0), (6, 0.65, 0.05),               # the division's depth
])
def test_find_overlaps_matches_reference(seed, coef, n_frac):
    codes = reads(seed, n_frac)
    assert_same_links(ref.find_overlaps(codes, coef),
                      port.find_overlaps(codes, coef, device="cpu"))


@pytest.mark.parametrize("seed", [7, 8])
def test_repair_mode_matches_reference(seed):
    """init_active: only the given ends take part, no duplicate linking."""
    codes = reads(seed, 0.02)
    rng = np.random.default_rng(seed)
    act = (rng.random(N_READS) < 0.6, rng.random(N_READS) < 0.6)
    a = ref.find_overlaps(codes, 1.0, init_active=act)
    b = port.find_overlaps(codes, 1.0, init_active=act, device="cpu")
    np.testing.assert_array_equal(a.succ, b.succ)
    np.testing.assert_array_equal(a.overlap, b.overlap)
    assert (a.succ >= 0).any()


@pytest.mark.parametrize("seed", [9, 10])
def test_compaction_keeps_links(monkeypatch, seed):
    """With the one-segment threshold lowered the port compacts its table
    between segments; the reference's table is small enough to never
    compact. Compaction moves rows only, so the links stay the reference's."""
    monkeypatch.setattr(port, "_ONE_SEGMENT_MAX_ROWS", 64)
    compactions = []
    real_round = port._round

    def spy(i, L_, t, succ_g, ovl_g):
        compactions.append(t["ids"].numel())
        return real_round(i, L_, t, succ_g, ovl_g)

    monkeypatch.setattr(port, "_round", spy)
    codes = reads(seed, 0.02)
    assert_same_links(ref.find_overlaps(codes, 1.0),
                      port.find_overlaps(codes, 1.0, device="cpu"))
    assert len(set(compactions)) > 3 and min(compactions) < N_READS // 4


def init_codes(n, with_n, seed):
    """Random reads with many exact duplicates, N in a few symbols."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    codes[rng.integers(0, n, 800)] = codes[rng.integers(0, n, 800)]
    if with_n:
        codes[rng.random((n, L)) < 0.002] = 4
    return codes


@pytest.mark.parametrize("with_n", [False, True])
def test_init_hashes_and_links_match_reference(with_n):
    """K1: both full-read hashes (kernel G's plain version, with its sort
    key) and the duplicate links of the init (the stable sort, then kernel
    G2's plain version)."""
    n = 3072  # a bucket size, so the reference adds no padding rows
    codes = init_codes(n, with_n, 12 + with_n)
    lanes, nmask = ref_packed.pack_lanes(codes)
    init_fn = ref._build_init_fn(n, L, with_n)
    nm = nmask if with_n else np.zeros((n, 1), np.uint32)
    want = [np.asarray(x) for x in init_fn(lanes, nm, np.int32(n))]
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    h0, h0b, succ, ovl, a_s, a_p = port._init_links(lt, nt, L)
    got = [uint.tensor_to_np_u64(h0), uint.tensor_to_np_u64(h0b), a_s.numpy(),
           a_p.numpy(), succ.numpy(), ovl.numpy()]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (want[4] >= 0).sum() > 100
    # G's order key: min(h0, INV64 - 1) in unsigned order
    _, _, key = sweep_init.sweep_full_hashes(lt, nt, L, with_key=True)
    np.testing.assert_array_equal(uint.tensor_to_np_u64(uint.from_order_key64(key)),
                                  np.minimum(want[0], np.uint64(2**64 - 2)))


TIE_CASES = ("no tie", "all tied", "runs of equal reads")


def tie_codes(kind, n=3072):
    """Reads whose init keys never tie, all tie (each read twice or three
    times), or tie in runs of 1 to 40 equal reads."""
    rng = np.random.default_rng(TIE_CASES.index(kind) + 60)
    if kind == "no tie":
        return rng.integers(0, 4, size=(n, L), dtype=np.uint8)
    runs = np.tile([2, 3], n) if kind == "all tied" else rng.integers(1, 41, size=n)
    src = np.repeat(np.arange(runs.size), runs)[:n]
    if kind == "all tied":
        src[-3:] = src[-4]               # no run of one at the end
    base = rng.integers(0, 4, size=(runs.size, L), dtype=np.uint8)
    return base[src][rng.permutation(n)]


@pytest.mark.parametrize("kind", TIE_CASES)
def test_init_links_match_init_fn_at_ties(kind):
    """The init (`_init_links`: G's hashes and key, the stable sort, the
    rows' unlinked state and G2's links written over it) against the
    reference's `_build_init_fn` where no key ties, where every key ties
    and in runs of equal reads."""
    codes = tie_codes(kind)
    n = codes.shape[0]
    lanes, _ = ref_packed.pack_lanes(codes)
    want = [np.asarray(x) for x in ref._build_init_fn(n, L, False)(
        lanes, np.zeros((n, 1), np.uint32), np.int32(n))]
    lt, _ = state.lanes_to_device(lanes, None, "cpu")
    h0, h0b, succ, ovl, a_s, a_p = port._init_links(lt, None, L)
    got = [uint.tensor_to_np_u64(h0), uint.tensor_to_np_u64(h0b), a_s.numpy(), a_p.numpy(),
           succ.numpy(), ovl.numpy()]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    linked = int((want[4] >= 0).sum())
    assert linked == {"no tie": 0, "all tied": n - len(set(map(bytes, codes)))}.get(
        kind, linked) and (kind == "no tie" or linked > n // 3)


def ref_init_links(ks, sidx, hb_s, L_):
    """The reference's init linking (greedy_scs.py:448-465) in numpy, from
    the sorted keys, their rows and the sorted second hashes."""
    n = ks.size
    nxt_key_same = np.append(ks[1:] == ks[:-1], False)
    eq = np.append(hb_s[1:] == hb_s[:-1], False)
    matched = nxt_key_same & eq
    nxt = np.clip(np.append(sidx[1:], sidx[:1]), 0, n - 1)
    succ = np.full(n, -1, np.int32)
    ovl = np.zeros(n, np.int32)
    succ[sidx[matched]] = nxt[matched]
    ovl[sidx[matched]] = L_
    has_pred = np.zeros(n, bool)
    has_pred[nxt[matched]] = True
    return succ, ovl, succ < 0, ~has_pred


@pytest.mark.parametrize("pattern", ["h0b changes inside runs", "ties at both ends",
                                     "one long run"])
def test_init_links_where_keys_tie_and_h0b_differ(pattern):
    """G2's plain version (the links written over the unlinked state) where
    equal keys carry second hashes that differ inside a run (the chain
    breaks where h0b changes), at the first and last sorted positions, and
    over one long run, against the reference's linking lines."""
    rng = np.random.default_rng(len(pattern))
    runs = {"h0b changes inside runs": [7, 300, 1, 45, 2, 96] * 5,
            "ties at both ends": [2] + [1] * 500 + [3],
            "one long run": [2000]}[pattern]
    run_of = np.repeat(np.arange(len(runs)), runs)
    n = run_of.size
    ks = np.sort(rng.choice(1 << 62, len(runs), replace=False))[run_of] - (1 << 61)
    sidx = rng.permutation(n)
    pos = np.arange(n)
    hb_s = run_of * 4 + ((pos // 3) % 2 if pattern != "ties at both ends" else 0)
    h0b = np.empty(n, np.int64)
    h0b[sidx] = hb_s
    args = (torch.from_numpy(ks), torch.from_numpy(sidx), torch.from_numpy(h0b), L)
    want = ref_init_links(ks, sidx, hb_s, L)
    for link in (sweep_init.sweep_init_links, sweep_init.sweep_init_links_plain):
        state = sweep_init.link_defaults(n, "cpu")
        got = link(*args, state)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        assert all(g is o for g, o in zip(got, state))     # patched in place
    assert 0 < (want[0] >= 0).sum() < n - len(runs) + 1


@pytest.mark.parametrize("n", [1, 257, 3072])
def test_link_defaults_are_the_unlinked_state(n):
    """G2's fill (its plain version, and the wrapper on the CPU): every
    row's succ -1 and ovl 0 (int32), active_s and active_p true, as the
    reference's init starts them (greedy_scs.py:457-465)."""
    for succ, ovl, a_s, a_p in (sweep_init.link_defaults_plain(n, "cpu"),
                                sweep_init.link_defaults(n, "cpu")):
        assert succ.shape == ovl.shape == a_s.shape == a_p.shape == (n,)
        assert succ.dtype == ovl.dtype == torch.int32 and a_s.dtype == a_p.dtype == torch.bool
        assert (succ == -1).all() and (ovl == 0).all() and a_s.all() and a_p.all()


@pytest.mark.parametrize("with_n", [False, True])
def test_full_hashes_match_hash_fn(with_n):
    """K4 (repair mode's hash-only init): kernel G's plain version against
    the reference's `_build_hash_fn`."""
    n = 3072
    codes = init_codes(n, with_n, 22 + with_n)
    lanes, nmask = ref_packed.pack_lanes(codes)
    nm = nmask if with_n else np.zeros((n, 1), np.uint32)
    want = [np.asarray(x) for x in ref._build_hash_fn(n, L, with_n)(lanes, nm)]
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    got = sweep_init.sweep_full_hashes(lt, nt, L)
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(uint.tensor_to_np_u64(g), w)


@pytest.mark.parametrize("L_,with_n", [(16, False), (17, True), (37, True), (64, False),
                                        (255, True)])
def test_full_hashes_at_any_read_length(L_, with_n):
    """Kernel G's plain version against the reference's `_build_hash_fn` at
    read lengths on and off the 16-symbol lane, up to the longest read."""
    n = 256
    rng = np.random.default_rng(L_)
    codes = rng.integers(0, 4, size=(n, L_), dtype=np.uint8)
    if with_n:
        codes[rng.random((n, L_)) < 0.01] = 4
    lanes, nmask = ref_packed.pack_lanes(codes)
    nm = nmask if with_n else np.zeros((n, 1), np.uint32)
    want = [np.asarray(x) for x in ref._build_hash_fn(n, L_, with_n)(lanes, nm)]
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    for g, w in zip(sweep_init.sweep_full_hashes(lt, nt, L_), want):
        np.testing.assert_array_equal(uint.tensor_to_np_u64(g), w)


def chunked_hashes(lanes, nmask, L: int):
    """Kernel G's loop (csrc/sweep_init.cu) in torch, on the tables it reads
    (`sweep_init.table_tensor`): per lane word, four bytes of h = h * X^4 +
    T[byte] + TN[nibble], and the read's last word byte by byte, then symbol
    by symbol. -> (h0, h0b, key) [n] int64."""
    tab = sweep_init.table_tensor("cpu")
    A, B = int(ref.HASH_BASE64), int(ref.HASH_BASE64B)
    a4, b4 = (uint.s64(pow(x, 4, 1 << 64)) for x in (A, B))
    n = lanes.shape[0]
    ha = torch.zeros((n,), dtype=torch.int64)
    hb = torch.zeros_like(ha)
    for w in range(-(-L // 16)):
        word = lanes[:, w]
        nb = (torch.zeros_like(word) if nmask is None
              else (nmask[:, w // 2] >> (0 if w % 2 else 16)) & 0xFFFF)
        syms = min(16, L - 16 * w)
        for j in range(syms // 4):
            e = tab[((word >> (24 - 8 * j)) & 0xFF).long()]
            ha, hb = ha * a4 + e[:, 0], hb * b4 + e[:, 1]
            if nmask is not None:
                f = tab[256 + ((nb >> (12 - 4 * j)) & 0xF).long()]
                ha, hb = ha + f[:, 0], hb + f[:, 1]
        for s_ in range(syms & ~3, syms):
            v = (((word >> (30 - 2 * s_)) & 3) + (((nb >> (15 - s_)) & 1) << 2)).long()
            ha, hb = ha * uint.s64(A) + v, hb * uint.s64(B) + v
    return ha, hb, torch.where(ha == -1, -2, ha) ^ uint.SIGN64


@pytest.mark.parametrize("base", ["A", "B"])
def test_chunk_tables_are_four_horner_steps(base):
    """Each byte's entry is four steps h * X + code from h = 0, and each
    nibble's four steps of h * X + 4 * bit: kernel G's tables, as uploaded."""
    x = int(ref.HASH_BASE64 if base == "A" else ref.HASH_BASE64B)
    col = sweep_init.table_tensor("cpu")[:, "AB".index(base)]
    t, tn = sweep_init.chunk_tables(x)

    def horner(vals):
        h = 0
        for v in vals:
            h = (h * x + v) % (1 << 64)
        return h

    assert t == [horner([(b >> (6 - 2 * i)) & 3 for i in range(4)]) for b in range(256)]
    assert tn == [horner([4 * ((b >> (3 - i)) & 1) for i in range(4)]) for b in range(16)]
    assert uint.tensor_to_np_u64(col).tolist() == t + tn


@pytest.mark.parametrize("L_", [1, 3, 4, 16, 17, 37, 99, 100, 255])
@pytest.mark.parametrize("with_n", [False, True])
def test_chunked_hashes_match_plain_and_hash_fn(L_, with_n):
    """Kernel G's chunked Horner (its loop in torch, on its tables) against
    G's plain version and the reference's `_build_hash_fn`, at read lengths
    on and off the byte and the lane; with N, one row is all N."""
    n = 256
    rng = np.random.default_rng(100 + L_)
    codes = rng.integers(0, 4, size=(n, L_), dtype=np.uint8)
    if with_n:
        codes[rng.random((n, L_)) < 0.05] = 4
        codes[7] = 4
    lanes, nmask = ref_packed.pack_lanes(codes)
    nm = nmask if with_n else np.zeros((n, 1), np.uint32)
    want = [np.asarray(x) for x in ref._build_hash_fn(n, L_, with_n)(lanes, nm)]
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    got = chunked_hashes(lt, nt, L_)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(uint.tensor_to_np_u64(g), w)
    for g, p in zip(got, sweep_init.sweep_full_hashes_plain(lt, nt, L_, with_key=True)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("with_n", [False, True])
def test_chunked_key_matches_init_fn(with_n):
    """Kernel G's chunked Horner and its order key against the reference's
    `_build_init_fn` (K1): h0, h0b and min(h0, INV64 - 1) in unsigned order."""
    n = 384
    codes = init_codes(n, with_n, 40 + with_n)
    lanes, nmask = ref_packed.pack_lanes(codes)
    nm = nmask if with_n else np.zeros((n, 1), np.uint32)
    want = [np.asarray(x) for x in ref._build_init_fn(n, L, with_n)(lanes, nm, np.int32(n))]
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    h0, h0b, key = chunked_hashes(lt, nt, L)
    np.testing.assert_array_equal(uint.tensor_to_np_u64(h0), want[0])
    np.testing.assert_array_equal(uint.tensor_to_np_u64(h0b), want[1])
    np.testing.assert_array_equal(uint.tensor_to_np_u64(uint.from_order_key64(key)),
                                  np.minimum(want[0], np.uint64(2**64 - 2)))


T_H = 1024   # rows a tile of kernel H (csrc/sweep_compact.cu kTile)
# kind -> (rows, keep probability a side, N, kept rows of the first tile mod 4)
COMPACT_CASES = {
    "random": (3072, 0.3, False, None), "none kept": (3072, 0.0, False, None),
    "all kept": (3072, 1.0, False, None), "random, N": (3072, 0.3, True, None),
    "tile - 1": (T_H - 1, 0.3, False, None), "tile": (T_H, 0.3, False, None),
    "tile + 1": (T_H + 1, 0.3, True, None),
    "base 1 mod 4": (2 * T_H + 37, 0.3, False, 1), "base 2 mod 4": (2 * T_H + 37, 0.3, False, 2),
    "base 3 mod 4": (2 * T_H + 37, 0.3, True, 3),
}


@pytest.mark.parametrize("kind", list(COMPACT_CASES))
def test_sweep_compact_matches_compact_fn(kind):
    """K3: kernel H's plain version against the reference's
    `_build_compact_fn` on a random table: the kept rows in the same order,
    every array, and the three counts the segment end reads; at H's tile
    size (n off and on it) and with the rows kept before the second tile at
    each residue mod 4 (where H's 16-byte stores start their runs)."""
    n, act, with_n, residue = COMPACT_CASES[kind]
    rng = np.random.default_rng(list(COMPACT_CASES).index(kind))
    codes = init_codes(n, with_n, 30)
    lanes, nmask = ref_packed.pack_lanes(codes)
    nm = nmask if with_n else np.zeros((n, 1), np.uint32)
    ids = np.sort(rng.choice(10 * n, n, replace=False)).astype(np.int32)
    hs = [rng.integers(0, 2**64, n, dtype=np.uint64) for _ in range(4)]
    a_s, a_p = rng.random(n) < act, rng.random(n) < act
    if kind == "all kept":
        a_s[::2] = False        # every row kept by one side or the other
    if residue is not None:     # keep rows of the first tile until its count fits
        dropped = np.nonzero(~(a_s | a_p)[:T_H])[0]
        a_p[dropped[:(residue - int((a_s | a_p)[:T_H].sum())) % 4]] = True
        assert int((a_s | a_p)[:T_H].sum()) % 4 == residue
    succ_l, ovl_l = np.full(n, -1, np.int32), np.zeros(n, np.int32)
    want = [np.asarray(x) for x in ref._build_compact_fn(n, n, L, with_n)(
        lanes, nm, ids, *hs, a_s, a_p, succ_l, ovl_l)][:9]
    lt, nt = state.lanes_to_device(lanes, nmask, "cpu")
    table = (lt, nt, torch.from_numpy(ids), *(state.hashes_to_device(h, "cpu") for h in hs),
             torch.from_numpy(a_s), torch.from_numpy(a_p))
    got, counts = sweep_compact.sweep_compact(*table)
    k = int((a_s | a_p).sum())
    assert counts.tolist() == [k, int(a_s.sum()), int(a_p.sum())]
    assert k == {"none kept": 0, "all kept": n}.get(kind, k) and (0 < k < n or act in (0, 1))
    for g, w in zip(got, want):
        if g is None:
            assert not with_n
            continue
        g = g[:k]
        g = uint.tensor_to_np_u64(g) if g.dtype == torch.int64 else (
            uint.tensor_to_np_u32(g) if g.dim() == 2 else g.numpy())
        np.testing.assert_array_equal(g, w[:k])


def test_divide_and_generate_matches_reference():
    codes = reads(13, 0.0)
    k_r, pg_r, order_r, pos_r = ref.divide_and_generate(codes, 0.65)
    k_p, pg_p, order_p, pos_p = port.divide_and_generate(codes, 0.65, device="cpu")
    for a, b in ((k_r, k_p), (pg_r, pg_p), (order_r, order_p), (pos_r, pos_p)):
        np.testing.assert_array_equal(a, b)
    assert 0 < pg_r.size < N_READS * L // 4


@pytest.fixture
def small_sweep_cap(monkeypatch):
    """Both packages' sweep table cap at 1000 rows: 2500 reads sweep in 3
    parts of 834 rows, and a repair set past 1000 rows repairs in tables of
    1000. Returns the row counts of the port's partitioned sweeps."""
    monkeypatch.setattr(ref, "_SWEEP_MAX_ROWS", 1000)
    monkeypatch.setattr(port, "_SWEEP_MAX_ROWS", 1000)
    calls = []
    real = port._find_overlaps_partitioned

    def spy(codes, coef, *, device, mesh=None):
        calls.append(codes.shape[0])
        return real(codes, coef, device=device, mesh=mesh)

    monkeypatch.setattr(port, "_find_overlaps_partitioned", spy)
    return calls


@pytest.mark.parametrize("seed,coef,n_frac", [(14, 1.0, 0.0), (15, 0.65, 0.03)])
def test_partitioned_sweep_matches_reference(small_sweep_cap, seed, coef, n_frac):
    """Row parts swept one after another, then the cross-part repair with
    the sweep's coef: the reference's links."""
    codes = reads(seed, n_frac)
    assert_same_links(ref.find_overlaps(codes, coef),
                      port.find_overlaps(codes, coef, device="cpu"))
    assert small_sweep_cap == [N_READS]


def test_divide_and_generate_partitioned_matches_reference(small_sweep_cap):
    """The fused stages 2+3 at the forced cap: a partitioned full sweep and
    a repair of the kept reads in tables of at most 1000 rows."""
    codes = reads(16, 0.0)
    k_r, pg_r, order_r, pos_r = ref.divide_and_generate(codes, 0.65)
    k_p, pg_p, order_p, pos_p = port.divide_and_generate(codes, 0.65, device="cpu")
    for a, b in ((k_r, k_p), (pg_r, pg_p), (order_r, order_p), (pos_r, pos_p)):
        np.testing.assert_array_equal(a, b)
    assert small_sweep_cap == [N_READS] and 0 < pg_r.size < N_READS * L // 4
