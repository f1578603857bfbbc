"""The order-preserving SE mode (`-o`) on the CPU: the port's SE_ORD
archive of 20,000 reads of 100 bp (past the numpy sweep mirror's 3,072, so
the port's torch sweep runs) against `pgrc_tpu`'s bytes, its decode judged
by the benchmark's frozen reference under the SE_ORD guarantee (the reads
back, in input order) with `faults.reordered` as the control, and the
spans and counters of the ORD path: in SE_ORD and PE_ORD, with `ord.reads`
the input's reads, and in SE, PE and MIN_PE none of them. The position
stream's varint64 arm, which only a joined pseudogenome past 2^32 symbols
takes, is held here on hand-made positions.

The input is the benchmark's `se100_human_ord` shape at a small scale
(`pgrc_bench/gen.py`: a repeat genome at 40x, 12% of the reads with a
low-quality tail).
"""
import io
import os

import numpy as np
import pytest
import torch

from pgrc_bench import faults, gen, reference
from pgrc_tpu import cli as ref_cli
from pgrc_tpu_torch import cli as port_cli
from pgrc_tpu_torch.archive import encoder, order
from pgrc_tpu_torch.config import PgRCParams
from pgrc_tpu_torch.streams.container import StreamReader
from pgrc_tpu_torch.utils import trace

N_READS, L, GENOME = 20_000, 100, 50_000
N_PAIRS = 2_000
ORD_SPANS = ("order.ord_positions", "order.ord_streams", "order.hq_entry_perm")
ORD_COUNTERS = ("ord.reads", "ord.position_bytes", "ord.wide")
SE_ORD = reference.Guarantee.of(paired=False, preserve_order=True)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("se_ord"))
    se = os.path.join(d, "se.fastq")
    gen.synth_fastq(se, N_READS, L, GENOME, seed=2**31 + 26, repeats=True, genome_seed=11)
    pe = [os.path.join(d, f"pe_{i}.fastq") for i in (1, 2)]
    gen.synth_fastq(pe[0], N_PAIRS, L, GENOME // 5, seed=2**31 + 27, pair=pe[1],
                    repeats=True, genome_seed=11)
    return d, se, pe


def _encode(paths, out, **kw):
    return encoder.encode(PgRCParams(src_fastq=paths[0], pair_fastq=paths[1] if len(paths) > 1
                                     else "", output=out, **kw), device=torch.device("cpu"))


def test_se_ord_archive_equals_reference_and_decodes_in_order(inputs):
    d, se, _ = inputs
    ref, port = os.path.join(d, "ref.pgtc"), os.path.join(d, "port.pgtc")
    assert ref_cli.main(["-o", "-i", se, ref]) == 0
    assert port_cli.main(["--device", "cpu", "-o", "-i", se, port]) == 0
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert b.read() == a.read()
    want = reference.expected([se], SE_ORD)
    assert reference.verdict(port, want, SE_ORD) == {"reads_differ": 0, "reads_out_of_order": 0}


def test_reordered_se_ord_archive_fails_only_the_order_check(inputs):
    d, se, _ = inputs
    out = os.path.join(d, "reordered.pgtc")
    with faults.reordered():
        _encode([se], out, preserve_order=True)
    got = reference.verdict(out, reference.expected([se], SE_ORD), SE_ORD)
    assert got["reads_differ"] == 0 and got["reads_out_of_order"] > 0


@pytest.mark.parametrize("mode", ["SE_ORD", "PE_ORD"])
def test_ord_spans_and_counters(inputs, mode):
    d, se, pe = inputs
    paths = [se] if mode == "SE_ORD" else pe
    stats = _encode(paths, os.path.join(d, f"{mode}.pgtc"), preserve_order=True)
    names = [s["name"] for s in stats.spans]
    by_name = {s["name"]: s for s in stats.spans}
    assert all(names.count(n) == 1 for n in ORD_SPANS)
    parent = lambda n: stats.spans[by_name[n]["parent"]]["name"]  # noqa: E731
    assert parent("order.ord_positions") == parent("order.ord_streams") == "order.order_info"
    assert parent("order.hq_entry_perm") == "order.hq_section"
    reads = N_READS if mode == "SE_ORD" else 2 * N_PAIRS
    assert stats.reads_total == reads
    assert by_name["order.ord_positions"]["attrs"] == {"reads": reads, "wide": 0}
    assert by_name["order.hq_entry_perm"]["attrs"] == {"entries": stats.hq_count}
    assert stats.counters["ord.reads"] == reads
    assert stats.counters["ord.wide"] == 0
    streams = by_name["order.ord_streams"]["attrs"]
    assert streams["streams"] == (1 if mode == "SE_ORD" else 5)
    assert 0 < stats.counters["ord.position_bytes"] == streams["bytes"] < stats.archive_bytes


@pytest.mark.parametrize("mode,pair,kw", [("SE", False, {}), ("PE", True, {}),
                                          ("MIN_PE", True, {"ignore_pair_order": True})])
def test_no_ord_spans_or_counters_outside_the_ord_modes(inputs, mode, pair, kw):
    d, se, pe = inputs
    stats = _encode(pe if pair else [se], os.path.join(d, f"{mode}.pgtc"), **kw)
    assert not {s["name"] for s in stats.spans} & set(ORD_SPANS)
    assert not set(stats.counters) & set(ORD_COUNTERS)


@pytest.mark.parametrize("wide", [False, True])
def test_se_positions_round_trip_on_either_arm(wide):
    """encode_positions_se / decode_positions_se on positions below 2^32 and
    past it (the varint64 arm of a joined pg past 4G symbols), with the
    counters that say which arm was taken."""
    rng = np.random.default_rng(2**31 + 5)
    top = 6_700_000_000 if wide else 10_800_000
    pos = rng.integers(0, top, size=50_000, dtype=np.int64)
    if wide:
        pos[7] = 2**32 + 3
    out = io.BytesIO()
    with trace.record("encode") as rec:
        order.encode_positions_se(out, pos)
    buf = out.getvalue()
    assert rec.counters == {"ord.reads": pos.size, "ord.position_bytes": len(buf),
                            "ord.wide": int(wide)}
    got = order.decode_positions_se(StreamReader(buf), pos.size, wide)
    np.testing.assert_array_equal(got, pos)


def test_pe_positions_round_trip_on_the_wide_arm():
    """encode_positions_pe's varint64 arm (its flag byte 1), counted like
    the SE arm: both mates of a pair count in `ord.reads`."""
    rng = np.random.default_rng(2**31 + 6)
    base = rng.integers(2**32, 2**33, size=5_000, dtype=np.int64)
    mate = base + rng.integers(-400, 400, size=base.size)
    mate[::7] = rng.integers(0, 2**33, size=mate[::7].size)   # past the u16 offsets
    pos = np.empty(2 * base.size, dtype=np.int64)
    pos[0::2], pos[1::2] = base, mate
    out = io.BytesIO()
    with trace.record("encode") as rec:
        order.encode_positions_pe(out, pos)
    buf = out.getvalue()
    assert buf[0] == 1
    assert rec.counters == {"ord.reads": pos.size, "ord.position_bytes": len(buf) - 1,
                            "ord.wide": 1}
    np.testing.assert_array_equal(order.decode_positions_pe(StreamReader(buf), pos.size), pos)
