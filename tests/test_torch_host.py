"""The port's copy of the host layer against `pgrc_tpu`'s: the same bytes out
of the same inputs (made from a numpy seed), and archives that each
package's decoder reads exactly.

Stream coders, the PGTC container, varints, FASTQ parsing and the packers
are compared byte for byte; the cross-decode cases compress one input pair
in each archive mode with both packages and decode each archive with both
decoders.
"""
import os

import numpy as np
import pytest

from pgrc_tpu import cli as ref_cli
from pgrc_tpu.archive import decoder as ref_decoder
from pgrc_tpu.core import fastq as ref_fastq
from pgrc_tpu.core import packed as ref_packed
from pgrc_tpu.streams import codecs as ref_codecs
from pgrc_tpu.streams import container as ref_container
from pgrc_tpu.streams import props as ref_props
from pgrc_tpu.utils import varint as ref_varint
from pgrc_tpu_torch import cli as port_cli
from pgrc_tpu_torch.archive import decoder as port_decoder
from pgrc_tpu_torch.core import fastq as port_fastq
from pgrc_tpu_torch.core import packed as port_packed
from pgrc_tpu_torch.streams import codecs as port_codecs
from pgrc_tpu_torch.streams import container as port_container
from pgrc_tpu_torch.streams import props as port_props
from pgrc_tpu_torch.utils import dna
from pgrc_tpu_torch.utils import varint as port_varint

C = port_codecs
CODECS = {  # name -> (coder id, p1, p2, symbol alphabet of the test data)
    "store": (C.STORE, 0, 0, 256),
    "zlib": (C.ZLIB, 0, 0, 256),
    "lzma": (C.LZMA_CODER, C.LEVEL_NORMAL, 1, 256),
    "lzma period 4": (C.LZMA_CODER, C.LEVEL_MAX, 4, 256),
    "zstd": (C.ZSTD, 19, 0, 256),
    "range o0": (C.RANGE_O0, 0, 0, 256),
    "range o1 period 2": (C.RANGE_O1, 0, 2, 256),
    "varlen dna book 0": (C.VARLEN_DNA, 0, C.LEVEL_NORMAL, 6),
    "varlen dna book 1": (C.VARLEN_DNA, 1, C.LEVEL_NORMAL, 6),
    "varlen dna book 2": (C.VARLEN_DNA, 2, C.LEVEL_NORMAL, 6),
    "range ctx o2 nsym 4": (C.RANGE_CTX, 2, 4, 4),
    "range ctx o1 nsym 256": (C.RANGE_CTX, 1, 0, 256),
    "blocked lzma": (C.BLOCKED, C.LZMA_CODER, C.LEVEL_NORMAL, 256),
    "rans": (C.RANS, 0, 0, 256),
}


def skewed_bytes(rng, n, nsym):
    """Bytes below nsym with a skewed, repetitive distribution."""
    p = 1.0 / np.arange(1, nsym + 1) ** 1.5
    data = rng.choice(nsym, size=n, p=p / p.sum()).astype(np.uint8)
    data[n // 3: n // 3 + 2000] = data[:2000]      # a long repeat
    return data.tobytes()


@pytest.mark.parametrize("name", list(CODECS))
def test_codec_round_trips_with_reference_bytes(name):
    cid, p1, p2, nsym = CODECS[name]
    data = skewed_bytes(np.random.default_rng(list(CODECS).index(name)), 60_000, nsym)
    port, ref = port_codecs.Codec(cid, p1, p2), ref_codecs.Codec(cid, p1, p2)
    assert port_codecs.is_available(port) == ref_codecs.is_available(ref)
    if not port_codecs.is_available(port):   # zstandard not installed here
        return
    blob = port.compress(data)
    assert blob == ref.compress(data)
    assert port.decompress(blob, len(data)) == data
    assert ref.decompress(blob, len(data)) == data


KINDS = {"hq_off": 256, "hq_rc": 2, "hq_mis_sym": 4, "hq_mis_off": 256, "pg_off": 256,
         "pair_order": 256, "joined_pg": 6}   # stream kind -> its alphabet


def test_container_writes_reference_bytes_and_reads_back():
    rng = np.random.default_rng(7)
    payloads = [skewed_bytes(rng, int(rng.integers(2001, 40_000)), nsym)
                for nsym in KINDS.values()] + [b""]
    kinds = list(KINDS) + ["pg_off"]
    outs = []
    for props, container in ((port_props, port_container), (ref_props, ref_container)):
        buf = bytearray()

        class Sink:
            def write(self, b):
                buf.extend(b)

        container.write_streams(Sink(), [props.job(k, f"s{i}", d)
                                         for i, (k, d) in enumerate(zip(kinds, payloads))])
        outs.append(bytes(buf))
    assert outs[0] == outs[1]
    for container in (port_container, ref_container):
        assert container.StreamReader(outs[0]).read_many(len(payloads)) == payloads


def test_stream_dump_numbers_are_unique_under_threads(tmp_path):
    """-T's dump counter under 16 threads (more than the cores, a 10 us
    switch interval) dumping at once, as stage 7's writer thread and the
    main thread do: every dump gets its own number 000..N-1, none is lost
    or shared, and each file holds its stream's bytes."""
    import sys
    import threading

    n_threads, per = 16, 40
    d = str(tmp_path / "streams")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        port_container.set_stream_dump_dir(d)
        start = threading.Barrier(n_threads)

        def dump(t):
            start.wait(timeout=30)
            for i in range(per):
                port_container._dump_stream(f"t{t} s{i}", b"%d:%d" % (t, i))

        threads = [threading.Thread(target=dump, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        port_container.set_stream_dump_dir(None)
    names = sorted(os.listdir(d))
    assert [int(n[:3]) for n in names] == list(range(n_threads * per))
    for name in names:
        t, i = name[5:-4].split("_s")
        with open(os.path.join(d, name), "rb") as f:
            assert f.read() == b"%s:%s" % (t.encode(), i.encode())


def test_varints_match_reference():
    rng = np.random.default_rng(3)
    values = np.concatenate([np.arange(300), rng.integers(0, 1 << 62, 2000),
                             [127, 128, 16383, 16384, (1 << 63) - 1]]).astype(np.uint64)
    port_buf, ref_buf = bytearray(), bytearray()
    for v in values.tolist():
        port_varint.write_varint(port_buf, v)
        ref_varint.write_varint(ref_buf, v)
    assert port_buf == ref_buf
    pos, back = 0, []
    for _ in values:
        v, pos = port_varint.read_varint(port_buf, pos)
        back.append(v)
    assert back == values.tolist() and pos == len(port_buf)
    enc = port_varint.encode_varints(values)
    assert enc == ref_varint.encode_varints(values)
    np.testing.assert_array_equal(port_varint.decode_varints(enc, values.size), values)


def write_fastq(path, codes, qual):
    with open(path, "wb") as f:
        for i in range(codes.shape[0]):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, dna.VAL2SYM[codes[i]].tobytes(),
                                            qual[i].tobytes()))


def read_pair(tmp_path, n=1500, L=90, seed=5):
    """Two FASTQ files: reads with N bases and low-quality tails."""
    rng = np.random.default_rng(seed)
    paths, codes = [], []
    for i in range(2):
        c = rng.integers(0, 4, (n, L), dtype=np.uint8)
        c[rng.random((n, L)) < 0.002] = dna.N
        q = np.full((n, L), ord("I"), dtype=np.uint8)
        q[rng.random(n) < 0.25, L // 3:] = ord("#")
        paths.append(str(tmp_path / f"r{i + 1}.fastq"))
        write_fastq(paths[-1], c, q)
        codes.append(c)
    return paths, codes


@pytest.mark.parametrize("paired,revcomp", [(False, False), (True, False), (True, True)],
                         ids=["single", "pair", "pair-revcomp"])
def test_fastq_parsing_matches_reference(tmp_path, paired, revcomp):
    (p1, p2), codes = read_pair(tmp_path)
    args = (p1, p2 if paired else None, revcomp, 0.12, True)
    port, ref = port_fastq.read_divided(*args), ref_fastq.read_divided(*args)
    assert port.read_len == ref.read_len == codes[0].shape[1]
    for key in ("codes", "hq_mask", "n_mask"):
        np.testing.assert_array_equal(getattr(port, key), getattr(ref, key))
    assert 0 < port.hq_mask.sum() < port.hq_mask.size and port.n_mask.any()
    whole = port_fastq.read_fastq(p1)
    np.testing.assert_array_equal(whole.codes, ref_fastq.read_fastq(p1).codes)
    np.testing.assert_array_equal(whole.codes, codes[0])


@pytest.mark.parametrize("L", [100, 37, 16])
def test_packers_match_reference(L):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 4, (700, L), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = dna.N
    lanes, nmask = port_packed.pack_lanes(codes)
    ref_lanes, ref_nmask = ref_packed.pack_lanes(codes)
    np.testing.assert_array_equal(lanes, ref_lanes)
    np.testing.assert_array_equal(nmask, ref_nmask)
    acgt = codes & 3
    np.testing.assert_array_equal(port_packed.pack_2bit(acgt), ref_packed.pack_2bit(acgt))
    np.testing.assert_array_equal(port_packed.unpack_2bit(port_packed.pack_2bit(acgt), L), acgt)
    text = acgt.ravel()[: 16 * 50 + 7]
    np.testing.assert_array_equal(port_packed.pack_text_2bit(text),
                                  ref_packed.pack_text_2bit(text))
    np.testing.assert_array_equal(port_packed.revcomp_codes_matrix(codes),
                                  ref_packed.revcomp_codes_matrix(codes))
    assert port_packed.num_lanes(L) == ref_packed.num_lanes(L)


# ---- cross-decode ---------------------------------------------------------

MODES = {"SE": ["-i", "{1}"], "PE": ["-i", "{1}", "{2}"], "MIN_PE": ["-s", "-i", "{1}", "{2}"],
         "SE_ORD": ["-o", "-i", "{1}"], "PE_ORD": ["-o", "-i", "{1}", "{2}"]}


@pytest.fixture(scope="module")
def genome_pair(tmp_path_factory):
    """Mates 150-450 symbols apart on one genome, half reverse complemented,
    1% substitutions, N bases and low-quality tails."""
    d = tmp_path_factory.mktemp("cross")
    rng = np.random.default_rng(17)
    n, L = 800, 80
    genome = rng.integers(0, 4, size=3000, dtype=np.uint8)
    starts = rng.integers(0, genome.size - L - 450, n)
    paths, codes = [], []
    for i, st in enumerate((starts, starts + rng.integers(150, 450, n))):
        c = genome[st[:, None] + np.arange(L)[None, :]]
        flip = rng.random(n) < 0.5
        c[flip] = dna.COMPL_VAL[c[flip][:, ::-1]]
        err = rng.random(c.shape) < 0.01
        c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
        c[rng.random(n) < 0.03, rng.integers(0, L)] = dna.N
        q = np.full(c.shape, ord("I"), dtype=np.uint8)
        q[rng.random(n) < 0.2, L // 2:] = ord("#")
        paths.append(str(d / f"in{i + 1}.fastq"))
        write_fastq(paths[-1], c, q)
        codes.append(c)
    return str(d), paths, codes


def decoded(decoder, archive, prefix, n_files):
    """Decode; -> the output files' bytes."""
    decoder.decode_to_files(archive, prefix)
    outs = [prefix + "_out"] if n_files == 1 else [prefix + "_out_1", prefix + "_out_2"]
    result = []
    for o in outs:
        with open(o, "rb") as f:
            result.append(f.read())
    return result


@pytest.mark.parametrize("mode", list(MODES))
def test_each_decoder_reads_the_other_packages_archive(genome_pair, mode):
    d, paths, codes = genome_pair
    argv = [a.format(None, *paths) for a in MODES[mode]]
    n_in = sum(a in paths for a in argv)
    archives = {}
    for who, main, head in (("ref", ref_cli.main, ()), ("port", port_cli.main,
                                                         ("--device", "cpu"))):
        archives[who] = os.path.join(d, f"{mode}.{who}.pgtc")
        assert main([*head, *argv, archives[who]]) == 0
    for made_by, archive in archives.items():
        by_port = decoded(port_decoder, archive, os.path.join(d, f"{mode}.{made_by}.p"), n_in)
        by_ref = decoded(ref_decoder, archive, os.path.join(d, f"{mode}.{made_by}.r"), n_in)
        assert by_port == by_ref
        got = [dna.SYM2VAL[np.frombuffer(b, np.uint8).reshape(-1, 81)[:, :80]] for b in by_port]
        if mode.endswith("ORD"):
            assert all(np.array_equal(g, w) for g, w in zip(got, codes[:n_in]))
        elif n_in == 2 and mode == "PE":
            assert port_decoder._multiset_equal(np.concatenate(got, axis=1),
                                                np.concatenate(codes, axis=1))
        else:
            assert port_decoder._multiset_equal(np.concatenate(got), np.concatenate(codes[:n_in]))
