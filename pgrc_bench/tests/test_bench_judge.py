"""The reference judges each archive by the guarantee of its configuration's
mode: on small hand-made matrices, and on the port's archives of the six
guarantees, encoded on the CPU from 1,200 pairs of 80 bp."""
import contextlib

import numpy as np
import pytest

from pgrc_bench import faults, gen, reference, run

G = reference.Guarantee
# PgRC's modes: the configuration (paired, flags) and the guarantee it asks for
TABLE = {
    "SE": ((False, []), G("SE", 1, "reads", False)),
    "PE": ((True, []), G("PE", 2, "pairs", False)),
    "MIN_PE": ((True, ["-s"]), G("MIN_PE", 2, "unordered pairs", False)),
    "S": ((True, ["-S"]), G("SE", 2, "reads", False)),
    "SE_ORD": ((False, ["-o"]), G("SE_ORD", 1, "reads", True)),
    "PE_ORD": ((True, ["-o"]), G("PE_ORD", 2, "pairs", True)),
}


def _guarantee(paired, flags):
    return run.guarantee({"paired": paired, "flags": flags})


@pytest.mark.parametrize("case", list(TABLE))
def test_configuration_asks_for_its_mode_s_guarantee(case):
    (paired, flags), want = TABLE[case]
    assert _guarantee(paired, flags) == want


@pytest.mark.parametrize("paired,flags,mode", [
    (True, ["-I"], "MIN_PE"), (True, ["-S", "-o"], "SE"), (True, ["-o", "-s"], "PE_ORD"),
    (False, ["-s"], "SE"), (False, ["-S", "-o"], "SE"), (True, ["-S", "-s"], "SE"),
])
def test_pgrc_s_precedence(paired, flags, mode):
    """-S before -o, -o before -s and -I; unpaired input without -o is SE."""
    assert _guarantee(paired, flags).mode == mode


# ------------------------------------------------- hand-made matrices

def _mats(g, rng, n=40, L=6):
    """An input of the guarantee's files: n distinct reads (pairs) of L codes."""
    base = rng.permutation(4**L)[: n * g.inputs]
    rows = (base[:, None] // 4 ** np.arange(L)[None, :] % 4).astype(np.uint8)
    return [rows[i * n:(i + 1) * n] for i in range(g.inputs)]


def _judge(g, want_mats, got_mats):
    """The checks of a decode `got_mats` against the input `want_mats`."""
    k = reference.unit_keys(want_mats, g)
    got = reference.unit_keys(got_mats, g)
    out = {"reads_differ": reference.multiset_difference(np.sort(k), np.sort(got))}
    if g.in_order:
        out["reads_out_of_order"] = reference.out_of_order(k, got)
    return out


def _decoded(g, mats):
    """What a sound archive of the guarantee decodes the input to."""
    return [np.concatenate(mats)] if g.outputs < g.inputs else mats


@pytest.mark.parametrize("case", list(TABLE))
def test_sound_decode_reads_0(case):
    g = TABLE[case][1]
    mats = _mats(g, np.random.default_rng(1))
    assert set(_judge(g, mats, _decoded(g, mats)).values()) == {0}


@pytest.mark.parametrize("case", list(TABLE))
def test_permutation_fails_only_the_order_check(case):
    g = TABLE[case][1]
    mats = _mats(g, np.random.default_rng(2))
    perm = np.random.default_rng(3).permutation(mats[0].shape[0])
    got = _judge(g, mats, _decoded(g, [m[perm] for m in mats]))
    assert got["reads_differ"] == 0
    if g.in_order:
        assert got["reads_out_of_order"] == int((perm != np.arange(perm.size)).sum()) > 0
    else:
        assert "reads_out_of_order" not in got


@pytest.mark.parametrize("case", ["PE", "MIN_PE", "PE_ORD"])
def test_mate_swapped_pairs_pass_only_min_pe(case):
    g = TABLE[case][1]
    m1, m2 = _mats(g, np.random.default_rng(4))
    swap = np.arange(m1.shape[0]) % 3 == 0
    got = [np.where(swap[:, None], m2, m1), np.where(swap[:, None], m1, m2)]
    checks = _judge(g, [m1, m2], got)
    if g.unit == "unordered pairs":
        assert set(checks.values()) == {0}
    else:
        assert checks["reads_differ"] == 2 * swap.sum()
        assert checks.get("reads_out_of_order", swap.sum()) == swap.sum()


@pytest.mark.parametrize("case", list(TABLE))
def test_a_changed_read_fails(case):
    g = TABLE[case][1]
    mats = _mats(g, np.random.default_rng(5))
    got = [m.copy() for m in _decoded(g, mats)]
    got[-1][7, 2] = (got[-1][7, 2] + 1) % 4
    checks = _judge(g, mats, got)
    assert checks["reads_differ"] == 2 and checks.get("reads_out_of_order", 1) == 1


def test_single_reads_of_a_pair_compare_both_files():
    """-S: the one decoded file against the reads of both input files, in
    any order; a decode of one file alone lacks the other's reads."""
    g = TABLE["S"][1]
    m1, m2 = _mats(g, np.random.default_rng(6))
    both = np.concatenate([m2, m1])[::-1]
    assert _judge(g, [m1, m2], [both]) == {"reads_differ": 0}
    assert _judge(g, [m1, m2], [m1]) == {"reads_differ": m2.shape[0]}


def test_lower_first_is_the_same_for_swapped_mates():
    a = np.array([[0, 1, 2], [3, 3, 0], [1, 1, 1]], np.uint8)
    b = np.array([[0, 1, 3], [3, 2, 0], [1, 1, 1]], np.uint8)
    lo, hi = reference.lower_first(a, b)
    assert np.array_equal(lo, [[0, 1, 2], [3, 2, 0], [1, 1, 1]])
    assert np.array_equal(hi, [[0, 1, 3], [3, 3, 0], [1, 1, 1]])
    lo2, hi2 = reference.lower_first(b, a)
    assert np.array_equal(lo, lo2) and np.array_equal(hi, hi2)


# ------------------------------------------------- the port's archives

@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Each case's archive of one input by the port on the CPU, and in the
    `-o` cases one more under `faults.reordered`."""
    import torch
    from pgrc_tpu_torch.archive import encoder

    d = tmp_path_factory.mktemp("judge")
    files = [str(d / "r1.fq"), str(d / "r2.fq")]
    gen.synth_fastq(files[0], 1200, 80, 4000, seed=2**31 + 25, pair=files[1])
    out = {}
    for case, ((paired, flags), g) in TABLE.items():
        fs = files if paired else files[:1]
        for fault in ("none", "reordered") if g.in_order else ("none",):
            path = str(d / f"{case}.{fault}.pgtc")
            with faults.reordered() if fault == "reordered" else contextlib.nullcontext():
                encoder.encode(run.params_for(run.parse_flags(flags), fs, path),
                               device=torch.device("cpu"))
            out[case, fault] = path
    return files, out


def _window_checks(files, paths, g):
    checks, failed = run.judge_window([{"archive": p} for p in paths], files, g)
    return {k: c["value"] for k, c in checks.items()}, failed


@pytest.mark.parametrize("case", list(TABLE))
def test_port_s_archive_reads_0(archives, case):
    files, out = archives
    (paired, _), g = TABLE[case]
    checks, failed = _window_checks(files if paired else files[:1], [out[case, "none"]], g)
    assert failed == 0 and set(checks.values()) == {0}
    order = ["reads_out_of_order"] if g.in_order else []
    assert list(checks) == ["reads_differ", "archives_failed", *order]


@pytest.mark.parametrize("case", ["SE_ORD", "PE_ORD"])
def test_reordered_archive_is_not_correct(archives, case):
    files, out = archives
    (paired, _), g = TABLE[case]
    fs = files if paired else files[:1]
    checks, failed = _window_checks(fs, [out[case, "reordered"]], g)
    assert failed == 1 and checks["reads_differ"] == 0 and checks["reads_out_of_order"] > 0
    # the multiset judge alone passes it
    assert reference.judge(out[case, "reordered"], reference.input_keys(fs), len(fs),
                           G(g.mode, g.inputs, g.unit, False)) == 0


# an archive judged by another mode's guarantee: (the archive, the configuration)
MISMATCHED = [("SE", "SE_ORD"), ("SE_ORD", "SE"), ("PE", "MIN_PE"), ("MIN_PE", "PE"),
              ("PE", "PE_ORD"), ("PE_ORD", "PE"), ("S", "PE"), ("PE", "S")]


@pytest.mark.parametrize("archive,config", MISMATCHED)
def test_archive_of_another_mode_fails(archives, capsys, archive, config):
    files, out = archives
    (paired, _), g = TABLE[config]
    checks, failed = _window_checks(files if paired else files[:1], [out[archive, "none"]], g)
    assert failed == 1 and checks["archives_failed"] == 1
    got = TABLE[archive][1].mode
    assert f"the archive's mode is {got}, its configuration's {g.mode}" in capsys.readouterr().err


def test_min_pe_decode_judged_under_pe_is_not_correct(archives):
    """The port's MIN_PE archive gives some pairs back with their mates
    swapped: correct under MIN_PE, not under PE's rule of ordered pairs."""
    from pgrc_bench.pgtc_decoder.archive import decoder

    files, out = archives
    mats = decoder.decode_to_matrices(decoder.load(out["MIN_PE", "none"]))
    for case, want in (("MIN_PE", 0), ("PE", None)):
        g = TABLE[case][1]
        diff = reference.multiset_difference(reference.expected(files, g).keys,
                                             np.sort(reference.unit_keys(mats, g)))
        assert diff == want if want is not None else diff > 0
