"""Every archive mode and flag through the port's CLI on the CPU: the
reference's archive bytes, and an exact decode.

One input pair (genome-sampled mates with errors, N bases and low-quality
tails) goes through `pgrc_tpu.cli` and `pgrc_tpu_torch.cli --device cpu`
with the same arguments. Inputs this small take both packages' numpy sweep
mirror; the device sweep and the blocked / wide matcher are held by
test_torch_overlap.py and test_torch_align.py. The decode check never uses
`decoder.validate` for SE or PE: it accepts swapped bytes and swapped pairs
(ROADMAP R1, R2). It compares decoded reads exactly: in order for ORD
modes, as a multiset of pairs for PE and MIN_PE (of unordered pairs for
MIN_PE, which drops the order within a pair), as a multiset of reads
otherwise.
"""
import os

import numpy as np
import pytest

from pgrc_tpu import cli as ref_cli
from pgrc_tpu.archive import decoder
from pgrc_tpu.utils import dna
from pgrc_tpu_torch import cli as port_cli
from test_roundtrip import read_lines_file

N_PAIRS, L = 1200, 80


def write_fastq(path, codes, qual):
    with open(path, "wb") as f:
        for i in range(codes.shape[0]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, dna.VAL2SYM[codes[i]].tobytes(),
                                            qual[i].tobytes()))


@pytest.fixture(scope="module")
def pair_input(tmp_path_factory):
    """Mates 150-450 symbols apart on one genome at ~48x, half of each file
    on the reverse strand, 1% substitutions, N in 3% of reads, 20% of reads
    with low-quality tails."""
    d = str(tmp_path_factory.mktemp("modes"))
    rng = np.random.default_rng(41)
    genome = rng.integers(0, 4, size=4000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - L - 450, N_PAIRS)
    codes = []
    for st in (starts, starts + rng.integers(150, 450, N_PAIRS)):
        c = genome[st[:, None] + np.arange(L)[None, :]]
        flip = rng.random(N_PAIRS) < 0.5
        c[flip] = dna.COMPL_VAL[c[flip][:, ::-1]]
        err = rng.random(c.shape) < 0.01
        c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
        c[rng.random(N_PAIRS) < 0.03, rng.integers(0, L)] = dna.N
        codes.append(c)
    paths = [os.path.join(d, f"in{i + 1}.fastq") for i in range(2)]
    for path, c in zip(paths, codes):
        qual = np.full(c.shape, ord("I"), dtype=np.uint8)
        qual[rng.random(N_PAIRS) < 0.2, L // 2:] = ord("#")
        write_fastq(path, c, qual)
    return d, paths, codes


CASES = {
    "PE": (["-i", "{1}", "{2}"], "pairs"),
    "MIN_PE": (["-s", "-i", "{1}", "{2}"], "unordered pairs"),
    "SE_ORD": (["-o", "-i", "{1}"], "order"),
    "PE_ORD": (["-o", "-i", "{1}", "{2}"], "order"),
    "S-on-pair": (["-S", "-i", "{1}", "{2}"], "reads"),
    "r": (["-r", "-i", "{1}", "{2}"], "pairs"),
    "n": (["-n", "-i", "{1}"], "reads"),
    "A": (["-A", "-i", "{1}"], "reads"),
    "Q": (["-Q", "-i", "{1}"], "reads"),
    "l2": (["-l", "2", "-i", "{1}"], "reads"),
    "q-g-M-p-I": (["-q", "60", "-g", "80", "-M", "4", "-p", "40", "-I", "-i", "{1}", "{2}"],
                  "unordered pairs"),
    "E4-B5": (["-E", "4", "|", "-B", "5", "-i", "{1}"], "reads"),
}


def compress(main, argv, out, head=()):
    """Run a CLI once, or twice for an "-E N | -B M" bisection (the first
    run stops at stage N and leaves its checkpoint, the second resumes)."""
    if "|" in argv:
        cut = argv.index("|")
        inputs = argv[argv.index("-i"):]
        assert main([*head, *argv[:cut], *inputs, out]) == 0
        argv = argv[cut + 1:]
    assert main([*head, *argv, out]) == 0


def unordered(a, b):
    """Each pair (a[i], b[i]) as one row, lexicographically lower read first."""
    diff = a != b
    first = diff.argmax(axis=1)
    rows = np.arange(a.shape[0])
    swap = diff.any(axis=1) & (a[rows, first] > b[rows, first])
    return np.where(swap[:, None], np.concatenate([b, a], axis=1),
                    np.concatenate([a, b], axis=1))


def decoded_equals_input(archive, prefix, kind, codes, n_inputs):
    n = decoder.decode_to_files(archive, prefix)
    got = ([read_lines_file(prefix + "_out")] if n_inputs == 1 or kind == "reads"
           else [read_lines_file(prefix + "_out_1"), read_lines_file(prefix + "_out_2")])
    want = codes[:n_inputs]
    if kind == "order":
        return n == sum(c.shape[0] for c in want) and all(
            np.array_equal(g, w) for g, w in zip(got, want))
    if kind == "pairs":
        return decoder._multiset_equal(np.concatenate(got, axis=1),
                                       np.concatenate(want, axis=1))
    if kind == "unordered pairs":
        return decoder._multiset_equal(unordered(*got), unordered(*want))
    return decoder._multiset_equal(np.concatenate(got), np.concatenate(want))


@pytest.mark.parametrize("case", list(CASES))
def test_mode_archive_equals_reference(pair_input, case):
    d, paths, codes = pair_input
    argv_t, kind = CASES[case]
    argv = [a.format(None, *paths) for a in argv_t]
    ref, port = (os.path.join(d, f"{case}.{who}.pgtc") for who in ("ref", "port"))
    compress(ref_cli.main, argv, ref)
    compress(port_cli.main, argv, port, head=("--device", "cpu"))
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert b.read() == a.read()
    n_inputs = sum(a in paths for a in argv)
    assert decoded_equals_input(port, os.path.join(d, f"{case}.dec"), kind, codes,
                                n_inputs)
