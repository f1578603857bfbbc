"""Paired-end 2x150 bp on the CPU: the port's PE archive of 4,000 pairs of
150 bp reads (8,000 reads, past the numpy sweep mirror's 3,072, so the
port's torch sweep runs at W 10 and 149 rounds a table) against
`pgrc_tpu`'s bytes, its decode judged by the benchmark's frozen reference
as a multiset of pairs, and the spans and counters of the pair path: in PE
and MIN_PE, with `pair.pairs` the input's pairs, and in SE none of them.

The input is the benchmark's `pe150_human` shape at a small scale
(`pgrc_bench/gen.py`: a repeat genome at 30x, 12% of the reads with a
low-quality tail, mate 2 150-449 bases after mate 1).
"""
import os

import numpy as np
import pytest
import torch

from pgrc_bench import gen, reference
from pgrc_tpu import cli as ref_cli
from pgrc_tpu_torch import cli as port_cli
from pgrc_tpu_torch.archive import encoder
from pgrc_tpu_torch.config import PgRCParams
from pgrc_tpu_torch.utils import trace

N_PAIRS, L, GENOME = 4000, 150, 40_000
PAIR_SPANS = ("input.mate", "order.pair_order", "order.pair_offsets", "order.pair_streams")
PAIR_COUNTERS = ("pair.pairs", "pair.offsets_full")


@pytest.fixture(scope="module")
def pe150(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pe150"))
    paths = [os.path.join(d, f"r{i}.fastq") for i in (1, 2)]
    gen.synth_fastq(paths[0], N_PAIRS, L, GENOME, seed=2**31 + 21, pair=paths[1],
                    repeats=True, genome_seed=11)
    return d, paths


def _encode(paths, out, **kw):
    return encoder.encode(PgRCParams(src_fastq=paths[0], pair_fastq=paths[1] if len(paths) > 1
                                     else "", output=out, **kw), device=torch.device("cpu"))


def test_pe150_archive_equals_reference_and_decodes(pe150):
    d, paths = pe150
    ref, port = os.path.join(d, "ref.pgtc"), os.path.join(d, "port.pgtc")
    assert ref_cli.main(["-i", *paths, ref]) == 0
    assert port_cli.main(["--device", "cpu", "-i", *paths, port]) == 0
    with open(ref, "rb") as a, open(port, "rb") as b:
        assert b.read() == a.read()
    assert reference.judge(port, reference.input_keys(paths), 2) == 0


@pytest.mark.parametrize("mode,kw", [("PE", {}), ("MIN_PE", {"ignore_pair_order": True})])
def test_pair_spans_and_counters_in_pe(pe150, mode, kw):
    """MIN_PE stores the mate file as it is (PgRC reverse-complements it in
    PE and PE_ORD only)."""
    d, paths = pe150
    stats = _encode(paths, os.path.join(d, f"{mode}.pgtc"), **kw)
    names = [s["name"] for s in stats.spans]
    by_name = {s["name"]: s for s in stats.spans}
    assert all(names.count(n) == 1 for n in PAIR_SPANS)
    parent = lambda n: stats.spans[by_name[n]["parent"]]["name"]  # noqa: E731
    assert parent("input.mate") == "input"
    assert parent("order.pair_order") == "order.order_info"
    assert parent("order.pair_offsets") == parent("order.pair_streams") == "order.pair_order"
    assert by_name["input.mate"]["attrs"] == {"rows": N_PAIRS, "revcomp": mode == "PE"}
    attrs = by_name["order.pair_order"]["attrs"]
    assert stats.counters["pair.pairs"] == attrs["pairs"] == N_PAIRS
    assert stats.counters["pair.offsets_full"] == attrs["full"]
    assert 0 < attrs["full"] < N_PAIRS


def test_no_pair_spans_or_counters_in_se(pe150):
    d, paths = pe150
    stats = _encode(paths[:1], os.path.join(d, "se.pgtc"))
    assert not {s["name"] for s in stats.spans} & set(PAIR_SPANS)
    assert not set(stats.counters) & set(PAIR_COUNTERS)


def test_pair_offsets_full_counts_offsets_past_255():
    """encode_pair_order's counters on a hand-made pg order: pairs (0, 1)
    adjacent, (2, 3) 255 apart (a byte), (4, 5) 256 apart (the fallback)."""
    import io

    from pgrc_tpu_torch.archive import order

    r = 600
    org = np.arange(r, dtype=np.int64)
    # list position -> original index: 2 at 1, 3 at 256; 4 at 257, 5 at 513
    layout = [0, 2] + list(range(6, 260)) + [3, 4] + list(range(260, 515)) + [5]
    layout += [i for i in org if i not in set(layout)]
    org = np.asarray(layout, dtype=np.int64)
    with trace.record("encode") as rec:
        order.encode_pair_order(io.BytesIO(), org, store_file_flags=True)
    offs = {}
    pos = {int(o): i for i, o in enumerate(org)}
    for p in range(r // 2):
        offs[p] = abs(pos[2 * p + 1] - pos[2 * p])
    assert rec.counters["pair.pairs"] == r // 2
    assert rec.counters["pair.offsets_full"] == sum(v > 255 for v in offs.values())
    assert offs[1] == 255 and offs[2] == 256
