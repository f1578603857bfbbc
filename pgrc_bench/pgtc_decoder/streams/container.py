"""PGTC stream container, the reading side: record headers and batched
decompression.

Mirrors the reference's per-stream header {rawLen, compLen, coderType}
(coders/CodersLib.cpp:315-380) and its collective parallel decompress
(readCompressedCollectiveParallel, CodersLib.cpp:503-641) via a thread pool
(liblzma/zstd release the GIL).

Stream record layout (little-endian):
    u8 coder_id | u8 p1 | u8 p2 | varint raw_len | varint comp_len | payload
A STORE record holds its payload as it is.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..utils.errors import PgtcFormatError
from ..utils.varint import read_varint
from .codecs import Codec

_MAX_WORKERS = 8

def _read_record(buf: memoryview, pos: int) -> tuple[Codec, int, bytes, int]:
    try:
        coder_id = buf[pos]
        p1 = buf[pos + 1]
        p2 = buf[pos + 2]
        raw_len, pos = read_varint(buf, pos + 3)
        comp_len, pos = read_varint(buf, pos)
    except (IndexError, ValueError) as e:
        raise PgtcFormatError(f"truncated stream record at offset {pos}") from e
    if pos + comp_len > len(buf):
        raise PgtcFormatError(
            f"stream record at offset {pos} claims {comp_len} payload bytes "
            f"but only {len(buf) - pos} remain"
        )
    payload = bytes(buf[pos : pos + comp_len])
    return Codec(coder_id, p1, p2), raw_len, payload, pos + comp_len


def _decompress_record(codec: Codec, payload: bytes, raw_len: int) -> bytes:
    try:
        out = codec.decompress(payload, raw_len)
    except PgtcFormatError:
        raise
    except Exception as e:  # lzma/zstd corruption errors, unknown coder ids
        raise PgtcFormatError(f"stream payload does not decode: {e}") from e
    if len(out) != raw_len:
        raise PgtcFormatError(
            f"stream decoded to {len(out)} bytes, header says {raw_len}"
        )
    return out


class StreamReader:
    """Sequential reader over a PGTC buffer with threaded batch decode."""

    def __init__(self, buf: bytes | memoryview, pos: int = 0):
        self.buf = memoryview(buf)
        self.pos = pos

    def read_one(self) -> bytes:
        codec, raw_len, payload, self.pos = _read_record(self.buf, self.pos)
        return _decompress_record(codec, payload, raw_len)

    def read_many(self, count: int) -> list[bytes]:
        items = []
        for _ in range(count):
            codec, raw_len, payload, self.pos = _read_record(self.buf, self.pos)
            items.append((codec, raw_len, payload))
        with ThreadPoolExecutor(max_workers=min(_MAX_WORKERS, max(count, 1))) as ex:
            return list(ex.map(lambda t: _decompress_record(t[0], t[2], t[1]),
                               items))
