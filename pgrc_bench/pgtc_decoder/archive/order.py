"""Order-information decoders for PE and ORD modes.

The reference's two order schemes in PGTC streams:

* PE (non-order-preserving): pair-relative offsets within the pg-order reads
  list (SeparatedPseudoGenomePersistence::compressReadsOrder, :220-339):
  for each pair, the distance between its two reads' list positions, split
  into a <=255 flag stream + u8 values + full-size fallbacks, plus a
  base-file-flag stream (which file the earlier read came from).
* ORD: original-index -> joined-pg-position arrays
  (compressReadsPgPositions, :445-574): SE_ORD stores the raw position array;
  PE_ORD stores base (even-index) positions plus pair-offset streams with a
  u16 flag/sign/value split and full-position fallback.

The PE decode's done-flag walk is the native `pair_walk_decode`.
"""
from __future__ import annotations

import numpy as np

from ..streams.container import StreamReader
from ..utils.errors import PgtcFormatError
from ..utils.varint import decode_varints


# ---------------------------------------------------------------------------
# PE mode: pair offsets within the pg-order list
# ---------------------------------------------------------------------------


def decode_pair_order(reader: StreamReader, store_file_flags: bool) -> np.ndarray:
    """The PE pair order: returns rl_idx_order [R] — for output
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
    if order is None or order.size != r:
        raise PgtcFormatError("malformed pair-offset streams")
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


def decode_positions_se(reader: StreamReader, count: int, wide: bool) -> np.ndarray:
    raw = reader.read_one()
    if wide:
        return decode_varints(raw, count).astype(np.int64)
    return np.frombuffer(raw, dtype=np.uint32).astype(np.int64)


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
