"""The port's multi-device path (`pgrc_tpu_torch.parallel.mesh`) on gloo CPU
ranks against pgrc_tpu's: the twins of tests/test_mesh.py's four tests,
then cases the port adds. Every comparison is exact: links, matches and
archive bytes.

Each port run spawns RANKS = 4 processes (one rank each, torch on one
thread, a file rendezvous in the test's tmp dir). The reference's tests run
8 virtual devices; 8 ranks would double each test's time, so the port's
4-rank result is held to pgrc_tpu's one-device result and, where
tests/test_mesh.py uses it, to its 8-device `make_mesh(8)` result.

The rank functions below run in the spawned processes, which import this
module: it imports nothing of pgrc_tpu (or JAX) at its top, only inside the
tests.
"""
import itertools
import os

import numpy as np
import pytest
import torch

from pgrc_tpu_torch.parallel import mesh as pmesh

RANKS = 4
_launches = itertools.count()


def on_ranks(tmp_path, fn, *args, n=RANKS):
    """fn(mesh, *args) on n gloo CPU ranks -> their returns, in rank order."""
    init = f"file://{tmp_path}/rendezvous_{next(_launches)}"
    return pmesh.launch(fn, n, *args, device="cpu", init_method=init, timeout_s=300)


def _set(module, caps: dict) -> None:
    for name, value in caps.items():
        setattr(module, name, value)


def rank_sweep(mesh, codes, coef, caps):
    """find_overlaps over the mesh -> (succ, overlap, rows of each table
    kernel H compacted)."""
    from pgrc_tpu_torch.overlap import greedy_scs as g

    _set(g, caps)
    compacted = []
    real = g.sweep_compact

    def spy(*args):
        compacted.append(args[2].numel())
        return real(*args)

    g.sweep_compact = spy
    res = g.find_overlaps(codes, coef, device="cpu", mesh=mesh)
    return res.succ, res.overlap, compacted


def rank_match(mesh, reads, index, pg, max_mis, accept_mis):
    from pgrc_tpu_torch.align import matcher

    m = matcher.match_reads(reads, index, pg, max_mis, accept_mis=accept_mis, device="cpu",
                            mesh=mesh)
    return m.pos, m.rc, m.mis


def rank_encode(mesh, src, out_dir, accept_mis):
    from pgrc_tpu_torch.archive import encoder
    from pgrc_tpu_torch.config import PgRCParams

    out = os.path.join(out_dir, f"rank{mesh.rank}.pgtc")
    params = PgRCParams(src_fastq=src, output=out)
    params.prematch_accept_mis = accept_mis
    encoder.encode(params, device="cpu", mesh=mesh)
    with open(out, "rb") as f:
        return f.read()


def rank_collectives(mesh, counts, send_rows):
    """The mesh's collectives on rank-dependent data: a variable gather of
    [c, 2] rows (rank r's row j = (r, j)) from a send buffer of
    max(c, send_rows) rows (junk past c; send_rows None: c rows), a count
    gather, a sum and a max; and the aten ops the gather dispatched."""
    from torch.utils._python_dispatch import TorchDispatchMode

    c = counts[mesh.rank]
    rows = torch.stack([torch.full((c,), mesh.rank), torch.arange(c)], 1).to(torch.int64)
    if send_rows is not None and send_rows > c:
        rows = torch.cat([rows, torch.full((send_rows - c, 2), -7, dtype=torch.int64)])
    ops = set()

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    with Log():
        parts = mesh.all_gather_parts(rows, counts)
    out = torch.cat(parts).numpy()
    got, on_device = mesh.gather_counts(torch.tensor([c, 10 * mesh.rank], dtype=torch.int64))
    assert on_device.tolist() == got.tolist()
    s = mesh.all_reduce(torch.tensor([mesh.rank + 1, -mesh.rank]), "sum").tolist()
    m = mesh.all_reduce(torch.tensor([mesh.rank + 1, -mesh.rank]), "max").tolist()
    return out, got, s, m, mesh.block(10), rows.shape[0], ops


def same_links(a, succ, ovl):
    np.testing.assert_array_equal(a.succ, succ)
    np.testing.assert_array_equal(a.overlap, ovl)


@pytest.fixture(scope="module")
def mesh8():
    import jax

    from pgrc_tpu.parallel import mesh as ref_mesh

    assert len(jax.devices()) >= 8, "conftest provisions 8 virtual CPU devices"
    return ref_mesh.make_mesh(8)


def test_find_overlaps_mesh_identical(tmp_path, mesh8):
    from pgrc_tpu.overlap import greedy_scs as ref
    from test_mesh import _synth_reads

    codes = _synth_reads(3000, 60, seed=11)
    r1 = ref.find_overlaps(codes)
    same_links(ref.find_overlaps(codes, mesh=mesh8), r1.succ, r1.overlap)
    for succ, ovl, _ in on_ranks(tmp_path, rank_sweep, codes, 1.0, {}):
        same_links(r1, succ, ovl)
    assert (r1.succ >= 0).sum() > 2500


@pytest.mark.parametrize("accept_mis", [2, 0], ids=["two-pass", "one-pass"])
def test_match_reads_mesh_identical(tmp_path, mesh8, accept_mis):
    """The reference's default (two passes: accept_mis 2, its `-l 2`) and
    the encoder's default (one full fan-out pass)."""
    from pgrc_tpu.align import matcher as am

    from pgrc_tpu_torch.align import matcher as port_matcher

    rng = np.random.default_rng(5)
    pg = rng.integers(0, 4, size=200_000, dtype=np.uint8)
    L = 80
    starts = rng.integers(0, pg.size - L, size=4000)
    reads = pg[starts[:, None] + np.arange(L)[None, :]].copy()
    e = rng.random(reads.shape) < 0.02
    reads[e] = (reads[e] + rng.integers(1, 4, size=int(e.sum()))) % 4
    index = am.build_index(pg, bits=18)
    m1 = am.match_reads(reads, index, pg, max_mismatches=26, accept_mis=accept_mis)
    m8 = am.match_reads(reads, index, pg, max_mismatches=26, accept_mis=accept_mis,
                        mesh=mesh8)
    for a, b in ((m1.pos, m8.pos), (m1.rc, m8.rc), (m1.mis, m8.mis)):
        np.testing.assert_array_equal(a, b)
    port_index = port_matcher.build_index(pg, bits=18)
    for pos, rc, mis in on_ranks(tmp_path, rank_match, reads, port_index, pg, 26, accept_mis):
        np.testing.assert_array_equal(pos, m1.pos)
        np.testing.assert_array_equal(rc, m1.rc)
        np.testing.assert_array_equal(mis, m1.mis)
    assert (m1.mis != 255).mean() > 0.9


@pytest.mark.parametrize("accept_mis", [0, 2], ids=["default", "-l 2"])
def test_encode_mesh_archive_identical(tmp_path, mesh8, accept_mis):
    """The production encoder over 4 ranks writes, on every rank, the
    archive pgrc_tpu writes on one device and on 8, and it round-trips
    through the port's decoder. `-l 2` runs the matcher's two passes."""
    from pgrc_tpu.archive import encoder as ref_encoder
    from pgrc_tpu.config import PgRCParams as RefParams
    from test_mesh import _synth_reads, _write_fastq

    from pgrc_tpu_torch.archive import decoder

    codes = _synth_reads(1500, 48, seed=3)
    src = str(tmp_path / "in.fastq")
    _write_fastq(src, codes)
    want = {}
    meshes = {"one": None, **({"eight": mesh8} if accept_mis == 0 else {})}
    for label, mesh in meshes.items():
        out = str(tmp_path / f"ref_{label}.pgtc")
        params = RefParams(src_fastq=src, output=out)
        params.prematch_accept_mis = accept_mis
        ref_encoder.encode(params, mesh=mesh)
        with open(out, "rb") as f:
            want[label] = f.read()
    assert len(set(want.values())) == 1
    blobs = on_ranks(tmp_path, rank_encode, src, str(tmp_path), accept_mis)
    assert all(b == want["one"] for b in blobs)
    rep = decoder.validate(str(tmp_path / "rank0.pgtc"), src)
    assert not rep["errors"], rep


def test_find_overlaps_mesh_with_compaction_matches_single(tmp_path, mesh8):
    """High coverage, 40,000 rows: with the one-segment threshold lowered to
    2048 rows each rank's table (10,000 rows) compacts with kernel H between
    segments, and the links stay the reference's on one device and on 8."""
    from pgrc_tpu.overlap import greedy_scs as ref

    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=20_000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - 60, size=40_000)
    codes = genome[starts[:, None] + np.arange(60)[None, :]].astype(np.uint8)
    r1 = ref.find_overlaps(codes, coef=1.0)
    same_links(ref.find_overlaps(codes, coef=1.0, mesh=mesh8), r1.succ, r1.overlap)
    outs = on_ranks(tmp_path, rank_sweep, codes, 1.0, {"_ONE_SEGMENT_MAX_ROWS": 2048})
    for succ, ovl, compacted in outs:
        same_links(r1, succ, ovl)
        assert compacted and compacted[0] == 10_000


def _equal_runs(seed):
    """Reads whose overlaps tie in long runs of equal hashes: 24 copies each
    of 9 reads that step one base along a short genome, shuffled, so every
    run of equal keys spans several ranks' rows."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=120, dtype=np.uint8)
    base = np.stack([genome[s:s + 60] for s in range(9)])
    return base[rng.permutation(np.repeat(np.arange(9), 24))]


def _few(seed):
    """3 reads, each overlapping the next by 45 bases: with 4 ranks one rank
    holds no row."""
    genome = np.random.default_rng(seed).integers(0, 4, size=100, dtype=np.uint8)
    return np.stack([genome[s:s + 60] for s in (30, 0, 15)])


def _synth(n, L, seed):
    from test_mesh import _synth_reads

    return _synth_reads(n, L, seed=seed)


PORT_CASES = {
    # label: (codes, coef, the reference's and the ranks' module caps)
    "n not divisible by the ranks": (lambda: _synth(3001, 60, 12), 1.0, {}),
    "a rank with no rows": (lambda: _few(4), 1.0, {}),
    "an equal-hash run across ranks": (lambda: _equal_runs(6), 1.0, {}),
    "the division's depth": (lambda: _synth(2000, 60, 14), 0.65, {}),
    # parts of 1000 rows and the repair across them; the reference's one
    # device skips its numpy mirror here, as a mesh does
    "partitioned, _SWEEP_MAX_ROWS 1000": (lambda: _synth(3000, 60, 13), 1.0,
                                          {"_SWEEP_MAX_ROWS": 1000, "_HOST_SWEEP_MAX": 0}),
}


@pytest.mark.parametrize("label", list(PORT_CASES))
def test_find_overlaps_mesh_port_cases(tmp_path, monkeypatch, label):
    from pgrc_tpu.overlap import greedy_scs as ref

    make, coef, caps = PORT_CASES[label]
    codes = make()
    for name, value in caps.items():
        monkeypatch.setattr(ref, name, value)
    r1 = ref.find_overlaps(codes, coef)
    for succ, ovl, _ in on_ranks(tmp_path, rank_sweep, codes, coef, caps):
        same_links(r1, succ, ovl)
    assert (r1.succ >= 0).any()


@pytest.mark.parametrize("counts, send_rows", [
    ([3, 0, 5], None), ([0, 0, 1], None), ([2, 2, 2], None), ([0, 0, 0], None),
    ([3, 0, 5], 7),     # every send buffer longer than the largest count: no pad copy
    ([3, 0, 5], 4),     # ranks 0 and 1 shorter than the largest count: padded
], ids=["counts0", "counts1", "counts2", "counts3", "longer buffers", "shorter buffers"])
def test_mesh_collectives(tmp_path, counts, send_rows):
    """The variable gather keeps rank order and drops the padding and what
    lies past a rank's count (a rank with nothing to send included), and a
    rank copies its rows into a padded buffer only where its send buffer is
    shorter than the largest count; counts, sums and maxima reach every
    rank; 10 rows split 4/3/3 in rank order."""
    want_rows = np.array([(r, j) for r, c in enumerate(counts) for j in range(c)],
                         dtype=np.int64).reshape(-1, 2)
    for rank, (rows, got, s, m, block, sent, ops) in enumerate(
            on_ranks(tmp_path, rank_collectives, counts, send_rows, n=3)):
        np.testing.assert_array_equal(rows, want_rows)
        np.testing.assert_array_equal(got, [[c, 10 * r] for r, c in enumerate(counts)])
        assert s == [6, -3] and m == [3, 0]
        assert block == ((0, 4), (4, 7), (7, 10))[rank]
        assert ("aten.copy_" in ops) == (sent < max(counts)), (rank, sent, ops)


@pytest.mark.parametrize("device_type, host_ranks, cards, want", [
    ("cpu", 4, 0, "gloo"),
    ("cuda", 4, 1, "gloo"),     # four ranks sharing one card
    ("cuda", 4, 4, "nccl"),     # a card for each rank
    ("cuda", 8, 4, "gloo"),     # two processes of 4 ranks on one 4-card host
    ("cuda", 4, 8, "nccl"),     # a host's 4 ranks of a larger group, 8 cards
])
def test_choose_backend(device_type, host_ranks, cards, want):
    """NCCL only when every rank on the host has a card of its own,
    whatever the group's size across hosts."""
    assert pmesh.choose_backend(device_type, host_ranks, cards) == want
