"""Canonical per-stream codec configuration table (PropsLibrary role).

The reference centralizes each stream's coder parameters in
coders/PropsLibrary.cpp:1-175 (LZMA dict/lc/lp/pb tunings, PPMd orders,
reads-positions props, ...). This module is that table for the PGTC
archive: one place mapping a stream kind to its primary codec and the
selector alternatives probed against it (the RANGE_CTX order-k context
coder fills the PPMd role, zstd the FSE role).

Stream kinds with a data period pass it through (e.g. 4-byte little-endian
position words -> period 4), matching the reference's lc/lp/pb
data-period tuning.
"""
from __future__ import annotations

from . import codecs
from .codecs import Codec
from .container import CompressionJob

_L = codecs.LZMA_CODER
_Z = codecs.ZSTD
_RC = codecs.RANGE_CTX
_NORMAL = codecs.LEVEL_NORMAL


def _lzma(period: int = 1) -> Codec:
    return Codec(_L, _NORMAL, period)


def _zstd() -> Codec:
    return Codec(_Z, 19)


def _rans() -> Codec:
    # own static rANS (the FSE/FiniteStateEntropy role, reference
    # coders/FSECoder.cpp) — always available, no optional dependency
    return Codec(codecs.RANS)


# kind -> (primary codec, selector alternatives)
PROPS: dict[str, tuple[Codec, list[Codec]]] = {
    # hq reads-list streams (v1.3-style decomposition)
    "hq_off": (_lzma(1), [_zstd(), Codec(_RC, 1), Codec(_RC, 2)]),
    "hq_rc": (Codec(_RC, 2, 2), [Codec(_RC, 11, 2), _zstd()]),
    "hq_mis_zero_flags": (Codec(_RC, 2, 2),
                          [Codec(_RC, 6, 2), Codec(_RC, 11, 2), _zstd()]),
    "hq_mis_cnt_values": (Codec(_RC, 1, 128), [_zstd(), _rans()]),
    "hq_mis_sym": (Codec(_RC, 3, 4), [Codec(_RC, 6, 4), _zstd()]),
    "hq_mis_off": (Codec(codecs.RANGE_O0), [_zstd(), _rans(), _lzma(1)]),
    # lq/N pg reads-list position deltas
    "pg_off": (_lzma(1), [_zstd(), _rans()]),
    # order info (PE pair order, ORD positions)
    "pair_order": (_lzma(1), [_zstd()]),
    "pair_flags": (_lzma(1), [_zstd()]),
    "pos_base": (_lzma(4), [_zstd()]),
    "pos_base_wide": (_lzma(8), [_zstd()]),
    "pos_delta": (_lzma(2), [_zstd()]),
    "org_idx": (_lzma(4), [_zstd()]),
    # stage-7 pg-vs-pg match streams
    "pgmatch_offsets": (_lzma(4), [_zstd()]),
    "pgmatch_lengths": (_lzma(1), [_zstd()]),
    # the joined residual pg sequence: VarLenDNA (3 codebooks) -> LZMA
    "joined_pg": (Codec(codecs.VARLEN_DNA, 0, _NORMAL),
                  [Codec(codecs.VARLEN_DNA, 1, _NORMAL),
                   Codec(codecs.VARLEN_DNA, 2, _NORMAL), _zstd()]),
}


def job(kind: str, label: str, data: bytes) -> CompressionJob:
    """Build a CompressionJob for a stream kind from the canonical table."""
    primary, alts = PROPS[kind]
    return CompressionJob(label, data, primary, alternatives=list(alts))


# typed helpers for the order/position streams (reference: reads-positions
# LZMA props with data-period tuning, PropsLibrary.cpp)

def u8_job(label: str, arr, period: int = 1) -> CompressionJob:
    import numpy as np

    return CompressionJob(
        label, np.ascontiguousarray(arr, dtype=np.uint8).tobytes(),
        _lzma(period), alternatives=[_zstd()])


def u16_job(label: str, arr) -> CompressionJob:
    import numpy as np

    return CompressionJob(
        label, np.ascontiguousarray(arr, dtype=np.uint16).tobytes(),
        _lzma(2), alternatives=[_zstd()])


def u32_job(label: str, arr) -> CompressionJob:
    import numpy as np

    return CompressionJob(
        label, np.ascontiguousarray(arr, dtype=np.uint32).tobytes(),
        _lzma(4), alternatives=[_zstd()])


def blob_job(label: str, data: bytes, period: int = 1) -> CompressionJob:
    return CompressionJob(label, data, _lzma(period), alternatives=[_zstd()])
