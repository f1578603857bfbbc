"""Entropy codec registry (host side).

Fills the role of coders/CodersLib.cpp + PropsLibrary.cpp: a uniform
compress/uncompress interface over a coder-id byte, with a raw-store fallback
when compression does not pay (CodersLib.cpp:315-334), a selector coder that
probes candidates and keeps the smallest (CodersLib.cpp:176-203), and a
compound (two-stage) coder.

Backends: LZMA (python stdlib liblzma, raw LZMA1 filters with the same
lc/lp/pb data-period tuning idea as PropsLibrary.cpp:9-58), zstd (fills the
FSE/Huffman role), an adaptive order-0/1 range coder (streams/rangecoder.py),
and a VarLen DNA codebook coder (streams/varlen_dna.py).
"""
from __future__ import annotations

import lzma
import zlib

import numpy as np

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

STORE = 0
ZLIB = 1
LZMA_CODER = 2
ZSTD = 3
RANGE_O0 = 4
RANGE_O1 = 5
VARLEN_DNA = 6
RANGE_CTX = 7   # order-k context range coder: p1 = order, p2 = nsym (0 -> 256)
BLOCKED = 8     # parallel-blocks wrapper: p1 = inner coder id, p2 = inner p1
RANS = 9        # own static order-0 rANS (FSE/FiniteStateEntropy role)

BLOCK_SIZE = 4 << 20  # bytes per parallel block (reference ParallelBlocksCoder >=1 MiB)

# coder levels, mirroring CODER_LEVEL_FAST/NORMAL/MAX
LEVEL_FAST = 1
LEVEL_NORMAL = 2
LEVEL_MAX = 3


def _lzma_filters(level: int, period: int, dict_exp: int):
    # lc/lp/pb tuned by the data period (element width), following the
    # reference's LZMA_DATAPERIODCODE_* idea (coders/PropsLibrary.cpp:9-44).
    if period <= 1:
        lc, lp, pb = 3, 0, 0
    elif period == 2:
        lc, lp, pb = 1, 1, 1
    elif period == 4:
        lc, lp, pb = 0, 2, 2
    else:
        lc, lp, pb = 0, 3, 3
    preset = {LEVEL_FAST: 3, LEVEL_NORMAL: 9, LEVEL_MAX: 9}.get(level, 9)
    return [{
        "id": lzma.FILTER_LZMA2,
        "preset": preset,
        "dict_size": 1 << dict_exp,
        "lc": lc,
        "lp": lp,
        "pb": pb,
    }]


def lzma_compress(data: bytes, level: int = LEVEL_NORMAL, period: int = 1) -> bytes:
    dict_exp = min(26, max(16, (len(data) - 1).bit_length()))
    filters = _lzma_filters(level, period, dict_exp)
    return lzma.compress(data, format=lzma.FORMAT_RAW, filters=filters)


def lzma_decompress(data: bytes, level: int = LEVEL_NORMAL, period: int = 1,
                    raw_len: int = 0) -> bytes:
    dict_exp = min(26, max(16, (raw_len - 1).bit_length())) if raw_len else 26
    filters = _lzma_filters(level, period, dict_exp)
    return lzma.decompress(data, format=lzma.FORMAT_RAW, filters=filters)


def zstd_compress(data: bytes, level: int = 19) -> bytes:
    # no silent stand-in: a stream whose header says ZSTD must BE zstd
    # (the selector simply skips unavailable coders; the own-rANS coder
    # fills the FSE role everywhere)
    if _zstd is None:
        raise RuntimeError("zstd not available")
    return _zstd.ZstdCompressor(level=level).compress(data)


def zstd_decompress(data: bytes, raw_len: int) -> bytes:
    if _zstd is None:
        raise RuntimeError("archive uses zstd streams but zstd is not "
                           "available in this environment")
    return _zstd.ZstdDecompressor().decompress(data, max_output_size=max(raw_len, 1))


def rans_compress(data: bytes) -> bytes:
    from .. import native

    fast = native.rans_encode(data)
    if fast is not None:
        return fast
    from . import rans_py

    return rans_py.encode(data)


def rans_decompress(data: bytes, raw_len: int) -> bytes:
    from .. import native

    return native.rans_decode(data, raw_len)


def is_available(codec: "Codec") -> bool:
    """Selector gate: only coders usable in THIS environment are probed
    (a missing optional dependency must never silently change a stream's
    identity)."""
    cid = codec.coder_id
    if cid == ZSTD or (cid == BLOCKED and codec.p1 == ZSTD):
        return _zstd is not None
    return True


class Codec:
    """A concrete codec configuration (coder id + params).

    params must round-trip through the 3-byte header written by the container
    (see archive.py): we store (coder_id, p1, p2) where p1/p2 meaning is
    per-coder (LZMA: level, period; range: order, period; varlen: codebook id).
    """

    def __init__(self, coder_id: int, p1: int = 0, p2: int = 0):
        self.coder_id = coder_id
        self.p1 = p1
        self.p2 = p2
        # For VARLEN_DNA the inner codec is fixed by the format to
        # LZMA(level=p2 or NORMAL, period=1) so (coder_id, p1, p2) fully
        # describes the stream — the container header has no inner field.

    def compress(self, data: bytes) -> bytes:
        if self.coder_id == STORE:
            return data
        if self.coder_id == ZLIB:
            return zlib.compress(data, 9)
        if self.coder_id == LZMA_CODER:
            return lzma_compress(data, self.p1, self.p2)
        if self.coder_id == ZSTD:
            return zstd_compress(data, self.p1 or 19)
        if self.coder_id == RANS:
            return rans_compress(data)
        if self.coder_id in (RANGE_O0, RANGE_O1):
            from . import rangecoder

            order = 0 if self.coder_id == RANGE_O0 else 1
            return rangecoder.encode(np.frombuffer(data, dtype=np.uint8), order=order,
                                     period=self.p2 or 1)
        if self.coder_id == VARLEN_DNA:
            from . import varlen_dna

            packed = varlen_dna.encode(data, codebook_id=self.p1)
            inner = Codec(LZMA_CODER, self.p2 or LEVEL_NORMAL, 1)
            return inner.compress(packed)
        if self.coder_id == RANGE_CTX:
            from . import rangecoder

            return rangecoder.encode_ctx(
                np.frombuffer(data, dtype=np.uint8), nsym=self.p2 or 256,
                order=self.p1,
            )
        if self.coder_id == BLOCKED:
            # split into BLOCK_SIZE blocks compressed concurrently by the
            # inner codec (coders/CodersLib.cpp:422-493 ParallelBlocks role)
            from concurrent.futures import ThreadPoolExecutor

            from ..utils.varint import write_varint

            inner = Codec(self.p1, self.p2)
            blocks = [data[o : o + BLOCK_SIZE] for o in range(0, max(len(data), 1), BLOCK_SIZE)]
            with ThreadPoolExecutor(max_workers=min(8, len(blocks))) as ex:
                outs = list(ex.map(inner.compress, blocks))
            buf = bytearray()
            write_varint(buf, len(blocks))
            for b in outs:
                write_varint(buf, len(b))
            for b in outs:
                buf.extend(b)
            return bytes(buf)
        raise ValueError(f"unknown coder id {self.coder_id}")

    def decompress(self, data: bytes, raw_len: int) -> bytes:
        if self.coder_id == STORE:
            return data
        if self.coder_id == ZLIB:
            return zlib.decompress(data)
        if self.coder_id == LZMA_CODER:
            return lzma_decompress(data, self.p1, self.p2, raw_len)
        if self.coder_id == ZSTD:
            return zstd_decompress(data, raw_len)
        if self.coder_id == RANS:
            return rans_decompress(data, raw_len)
        if self.coder_id in (RANGE_O0, RANGE_O1):
            from . import rangecoder

            order = 0 if self.coder_id == RANGE_O0 else 1
            return rangecoder.decode(data, raw_len, order=order, period=self.p2 or 1).tobytes()
        if self.coder_id == VARLEN_DNA:
            from . import varlen_dna

            inner = Codec(LZMA_CODER, self.p2 or LEVEL_NORMAL, 1)
            # raw_len is the unpacked length (>= packed length), an upper
            # bound for the inner raw stream; LZMA raw streams self-terminate.
            packed = inner.decompress(data, raw_len)
            return varlen_dna.decode(packed, raw_len, codebook_id=self.p1)
        if self.coder_id == RANGE_CTX:
            from . import rangecoder

            return rangecoder.decode_ctx(
                data, raw_len, nsym=self.p2 or 256, order=self.p1
            ).tobytes()
        if self.coder_id == BLOCKED:
            from concurrent.futures import ThreadPoolExecutor

            from ..utils.varint import read_varint

            inner = Codec(self.p1, self.p2)
            nblocks, pos = read_varint(data, 0)
            lens = []
            for _ in range(nblocks):
                ln, pos = read_varint(data, pos)
                lens.append(ln)
            payloads = []
            for ln in lens:
                payloads.append(data[pos : pos + ln])
                pos += ln
            raw_lens = [min(BLOCK_SIZE, raw_len - i * BLOCK_SIZE) for i in range(nblocks)]
            with ThreadPoolExecutor(max_workers=min(8, nblocks or 1)) as ex:
                outs = list(ex.map(lambda t: inner.decompress(t[0], t[1]),
                                   zip(payloads, raw_lens)))
            return b"".join(outs)
        raise ValueError(f"unknown coder id {self.coder_id}")

    def key(self) -> tuple:
        return (self.coder_id, self.p1, self.p2)


PROBE_FRACTION = 0.1
MIN_PROBE_SIZE = 1 << 15


def select_best(codecs: list[Codec], data: bytes) -> tuple[Codec, bytes]:
    """Pick the best codec (the reference's selector coder,
    CodersLib.cpp:176-203): when the stream is large, each candidate
    compresses only a prefix probe (PROBE_FRACTION, >= MIN_PROBE_SIZE) and
    only the winner compresses the full stream."""
    if len(codecs) == 1:
        return codecs[0], codecs[0].compress(data)
    probe_len = max(MIN_PROBE_SIZE, int(len(data) * PROBE_FRACTION))
    if probe_len < len(data):
        probe = data[:probe_len]
        best = min(codecs, key=lambda c: len(c.compress(probe)))
        return best, best.compress(data)
    best = None
    best_out = None
    for c in codecs:
        out = c.compress(data)
        if best_out is None or len(out) < len(best_out):
            best, best_out = c, out
    return best, best_out
