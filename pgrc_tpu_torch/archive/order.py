"""Order-information encodings for PE and ORD modes.

Re-implements the reference's two order schemes with our PGTC streams:

* PE (non-order-preserving): pair-relative offsets within the pg-order reads
  list (SeparatedPseudoGenomePersistence::compressReadsOrder, :220-339):
  for each pair, the distance between its two reads' list positions, split
  into a <=255 flag stream + u8 values + full-size fallbacks, plus a
  base-file-flag stream (which file the earlier read came from).
* ORD: original-index -> joined-pg-position arrays
  (compressReadsPgPositions, :445-574): SE_ORD stores the raw position array;
  PE_ORD stores base (even-index) positions plus pair-offset streams with a
  u16 flag/sign/value split and full-position fallback.

Encoded pair streams are vectorized numpy; the PE decode's done-flag walk is
the only sequential loop (small, ~1 it/pair).
"""
from __future__ import annotations

import numpy as np

from ..streams import props
from ..streams.container import StreamReader
from ..utils import trace
from ..utils.varint import encode_varints, decode_varints


# per-stream codec choices come from the canonical props table
# (streams/props.py, the PropsLibrary role)
_u8_jobs = props.u8_job
_u32_job = props.u32_job


# ---------------------------------------------------------------------------
# PE mode: pair offsets within the pg-order list
# ---------------------------------------------------------------------------


def encode_pair_order(out, org_idxs: np.ndarray, store_file_flags: bool) -> None:
    """org_idxs: [R] original index of each read in joined pg order (R even).

    Streams: u8flag bitmap, u8 values, u32 fallback values, and (unless
    ignore-pair-order) a base-file flag per pair. Recorded as the span
    `order.pair_order` (attrs `pairs`, `full`: the offsets past 255) with
    children `order.pair_offsets` and `order.pair_streams`, and the
    counters `pair.pairs` and `pair.offsets_full`.
    """
    from ..streams.container import write_streams

    r = org_idxs.shape[0]
    with trace.span("order.pair_order", pairs=r // 2) as sp:
        with trace.span("order.pair_offsets"):
            rev = np.empty(r, dtype=np.int64)
            rev[org_idxs] = np.arange(r, dtype=np.int64)
            i1 = np.arange(r, dtype=np.int64)
            partner_org = org_idxs ^ 1
            i2 = rev[partner_org]
            is_base = i1 < i2                      # first occurrence of the pair
            base_rows = np.nonzero(is_base)[0]     # ordered by list position
            offs = (i2 - i1)[base_rows]
            in_u8 = offs <= 255
            flags = in_u8.astype(np.uint8)
            vals8 = offs[in_u8].astype(np.uint8)
            full = offs[~in_u8].astype(np.uint32)
        sp.attrs["full"] = full.size
        trace.count("pair.pairs", r // 2)
        trace.count("pair.offsets_full", full.size)
        with trace.span("order.pair_streams"):
            jobs = [
                _u8_jobs("pair offset u8 flags", flags),
                _u8_jobs("pair offset u8 values", vals8, period=2),
                _u32_job("pair offset full values", full),
            ]
            if store_file_flags:
                # 1 = base read came from the pair (second) file
                file_flag = (org_idxs[base_rows] & 1).astype(np.uint8)
                jobs.append(_u8_jobs("pair base file flags", file_flag))
            write_streams(out, jobs)


def decode_pair_order(reader: StreamReader, store_file_flags: bool) -> np.ndarray:
    """Inverse of encode_pair_order: returns rl_idx_order [R] — for output
    position i (original-ish order), the joined reads-list index, such that
    (2p, 2p+1) are the two reads of pair p, base first unless file-flag says
    the base was the pair-file read (then swapped)."""
    flags = np.frombuffer(reader.read_one(), dtype=np.uint8)
    vals8 = np.frombuffer(reader.read_one(), dtype=np.uint8)
    full = np.frombuffer(reader.read_one(), dtype=np.uint32)
    file_flag = None
    if store_file_flags:
        file_flag = np.frombuffer(reader.read_one(), dtype=np.uint8)
    n_pairs = flags.shape[0]
    r = n_pairs * 2
    # offsets per pair, in encode order
    offs = np.empty(n_pairs, dtype=np.int64)
    offs[flags == 1] = vals8
    offs[flags == 0] = full
    from .. import native

    order = native.pair_walk_decode(offs)
    if order is None:  # offsets the native walk refuses: the Python walk
        order = np.empty(r, dtype=np.int64)
        done = np.zeros(r, dtype=bool)
        i = 0
        for p in range(n_pairs):
            while done[i]:
                i += 1
            order[2 * p] = i
            order[2 * p + 1] = i + offs[p]
            done[i + offs[p]] = True
            i += 1
    if file_flag is not None:
        # swap pairs whose base read came from the pair file so that even
        # output slots always hold file-1 reads
        idx = np.nonzero(file_flag == 1)[0]
        tmp = order[2 * idx].copy()
        order[2 * idx] = order[2 * idx + 1]
        order[2 * idx + 1] = tmp
    return order


# ---------------------------------------------------------------------------
# ORD modes: original index -> joined pg position
# ---------------------------------------------------------------------------


def wide_positions(pos: np.ndarray) -> bool:
    """Whether the positions need the varint64 arm: one past 2^32 - 1."""
    return bool(pos.size) and int(pos.max()) > 0xFFFFFFFF


def _write_positions(out, jobs, reads: int, wide: bool) -> None:
    """Write the ORD position streams, as the span `order.ord_streams` (the
    codec probes and the compression), and count `ord.reads` (the reads
    whose position is stored), `ord.position_bytes` (the streams' records)
    and `ord.wide` (1 on the varint64 arm)."""
    from ..streams.container import write_streams

    with trace.span("order.ord_streams", streams=len(jobs)) as sp:
        stored = sp.attrs["bytes"] = sum(write_streams(out, jobs))
    trace.count("ord.reads", reads)
    trace.count("ord.position_bytes", stored)
    trace.count("ord.wide", int(wide))


def encode_positions_se(out, pos: np.ndarray) -> None:
    """SE_ORD: raw per-original-read joined-pg positions (u32 or u64 varints)."""
    wide = wide_positions(pos)
    if wide:
        job = props.blob_job("ord positions (varint64)",
                             encode_varints(pos.astype(np.uint64)))
    else:
        job = _u32_job("ord positions", pos.astype(np.uint32))
    _write_positions(out, [job], pos.size, wide)


def decode_positions_se(reader: StreamReader, count: int, wide: bool) -> np.ndarray:
    raw = reader.read_one()
    if wide:
        return decode_varints(raw, count).astype(np.int64)
    return np.frombuffer(raw, dtype=np.uint32).astype(np.int64)


def encode_positions_pe(out, pos: np.ndarray) -> None:
    """PE_ORD: base positions (even org idx) + pair offsets
    (compressReadsPgPositions, :463-530). Pairs sorted by base position for
    offset locality; u16 flag/sign/value split with full-position fallback.

    A leading raw flag byte selects wide (varint64) position streams when
    the joined pg exceeds 4 GB (reference uint_pg_len widening,
    pgrc/pg-config.h:39-44)."""
    r = pos.shape[0]
    base = pos[0::2]
    mate = pos[1::2]
    rank = np.argsort(base, kind="stable")
    b = base[rank]
    m = mate[rank]
    is_base_first = b <= m
    rel = np.abs(m.astype(np.int64) - b.astype(np.int64))
    in_u16 = rel <= 0xFFFF
    wide = wide_positions(pos)
    out.write(bytes([1 if wide else 0]))
    if wide:
        base_job = props.blob_job("ord-pe base positions (varint64)",
                                  encode_varints(base.astype(np.uint64)))
        full_job = props.blob_job(
            "ord-pe full mate positions (varint64)",
            encode_varints(m[~in_u16].astype(np.uint64)))
    else:
        base_job = _u32_job("ord-pe base positions", base.astype(np.uint32))
        full_job = _u32_job("ord-pe full mate positions", m[~in_u16].astype(np.uint32))
    jobs = [
        base_job,
        _u8_jobs("ord-pe offset u16 flags", in_u16.astype(np.uint8)),
        _u8_jobs("ord-pe offset sign flags", is_base_first[in_u16].astype(np.uint8)),
        props.u16_job("ord-pe offset u16 values", rel[in_u16]),
        full_job,
    ]
    _write_positions(out, jobs, r, wide)


def decode_positions_pe(reader: StreamReader, count: int) -> np.ndarray:
    wide = bool(reader.buf[reader.pos])
    reader.pos += 1
    raw_base = reader.read_one()
    in_u16 = np.frombuffer(reader.read_one(), dtype=np.uint8).astype(bool)
    sign = np.frombuffer(reader.read_one(), dtype=np.uint8).astype(bool)
    vals = np.frombuffer(reader.read_one(), dtype=np.uint16).astype(np.int64)
    raw_full = reader.read_one()
    n_full = int((~in_u16).sum())
    if wide:
        base = decode_varints(raw_base, count // 2).astype(np.int64)
        full = decode_varints(raw_full, n_full).astype(np.int64)
    else:
        base = np.frombuffer(raw_base, dtype=np.uint32).astype(np.int64)
        full = np.frombuffer(raw_full, dtype=np.uint32).astype(np.int64)
    n_pairs = base.shape[0]
    rank = np.argsort(base, kind="stable")
    b = base[rank]
    m = np.empty(n_pairs, dtype=np.int64)
    rel = np.zeros(in_u16.sum(), dtype=np.int64)
    rel[:] = vals
    signed = np.where(sign, rel, -rel)
    m[in_u16] = b[in_u16] + signed
    m[~in_u16] = full
    mate = np.empty(n_pairs, dtype=np.int64)
    mate[rank] = m
    pos = np.empty(count, dtype=np.int64)
    pos[0::2] = base
    pos[1::2] = mate
    return pos
