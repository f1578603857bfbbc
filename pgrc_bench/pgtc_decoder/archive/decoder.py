"""PGTC decoder chain.

Mirrors PgRCDecoder::decompressPgRC (pgrc/pgrc-decoder.cpp:7-98): parse the
header, load the three pseudogenomes + reads lists, then emit the DNA stream
in one of the four modes:

  SE       hq reads (pg order, rc+mismatch applied), then lq raw, then N raw
  PE       pair-order stream maps output slots to joined-list indexes;
           file2 reads of lq/N pgs are reverse-complemented on output
  SE_ORD   per-original-index joined-pg positions
  PE_ORD   base + pair-offset encoded positions

Unlike the reference there is no rc-flag flip pass at decode
(applyRevComplPairFileToPgs): flags and mismatches were stored in
final-output coordinates by the encoder.

Only the decode to read matrices is kept: the benchmark's reference reads
an archive with `load` and `decode_to_matrices`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import ARCHIVE_MAGIC
from ..config import MODE_SE, MODE_PE, MODE_ORD_SE, MODE_ORD_PE, MODE_MIN_PE
from ..pg.model import ReadsList
from ..pg.reconstruct import reconstruct_at
from ..streams.container import StreamReader
from ..utils import dna
from ..utils.errors import PgtcFormatError
from ..utils.varint import read_varint
from . import order as order_enc
from . import pgseq


@dataclass
class Archive:
    mode: int
    separate_n: bool
    revcomp_pair: bool
    read_len: int
    reads_total: int
    hq_count: int
    lq_count: int
    n_count: int
    hq_pg: np.ndarray
    lq_pg: np.ndarray
    n_pg: np.ndarray
    hq_reads: ReadsList           # pos empty in ORD modes (positions come from pos_by_org)
    lq_pos: np.ndarray
    n_pos: np.ndarray
    rl_idx_order: np.ndarray | None    # PE modes
    pos_by_org: np.ndarray | None      # ORD modes


def load(path: str) -> Archive:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != ARCHIVE_MAGIC:
        raise PgtcFormatError("not a PGTC archive")
    if len(buf) < 8:
        raise PgtcFormatError("truncated archive header")
    pos = 4
    ver_major, ver_minor, mode, flags = buf[4], buf[5], buf[6], buf[7]
    if (ver_major, ver_minor) != (1, 1):
        raise PgtcFormatError(
            f"unsupported archive version {ver_major}.{ver_minor}")
    separate_n = bool(flags & 1)
    revcomp_pair = bool(flags & 2)
    pos = 8
    read_len, pos = read_varint(buf, pos)
    reads_total, pos = read_varint(buf, pos)
    hq_count, pos = read_varint(buf, pos)
    lq_count, pos = read_varint(buf, pos)
    n_count, pos = read_varint(buf, pos)
    hq_pg_len, pos = read_varint(buf, pos)
    lq_pg_len, pos = read_varint(buf, pos)
    n_pg_len, pos = read_varint(buf, pos)

    reader = StreamReader(buf, pos)
    ord_mode = mode in (MODE_ORD_SE, MODE_ORD_PE)
    hq_reads = _read_hq_section(reader, hq_count, has_off=not ord_mode,
                                read_len=read_len)
    lq_pos_arr = _read_plain_pg_section(reader, lq_count)
    n_pos_arr = _read_plain_pg_section(reader, n_count) if separate_n \
        else np.zeros(0, dtype=np.int64)

    rl_idx_order = None
    pos_by_org = None
    if mode in (MODE_PE, MODE_MIN_PE):
        rl_idx_order = order_enc.decode_pair_order(
            reader, store_file_flags=(mode == MODE_PE)
        )
    elif mode == MODE_ORD_PE:
        pos_by_org = order_enc.decode_positions_pe(reader, reads_total)
    elif mode == MODE_ORD_SE:
        wide = (hq_pg_len + lq_pg_len + n_pg_len) > 0xFFFFFFFF
        pos_by_org = order_enc.decode_positions_se(reader, reads_total, wide)

    hq_pg, lq_pg, n_pg = pgseq.read_pg_sequences(reader, hq_pg_len)
    if (len(hq_pg) != hq_pg_len or len(lq_pg) != lq_pg_len
            or len(n_pg) != n_pg_len):
        raise PgtcFormatError("restored pg lengths disagree with header")
    return Archive(
        mode=mode, separate_n=separate_n, revcomp_pair=revcomp_pair,
        read_len=read_len, reads_total=reads_total,
        hq_count=hq_count, lq_count=lq_count, n_count=n_count,
        hq_pg=hq_pg, lq_pg=lq_pg, n_pg=n_pg,
        hq_reads=hq_reads, lq_pos=lq_pos_arr, n_pos=n_pos_arr,
        rl_idx_order=rl_idx_order, pos_by_org=pos_by_org,
    )


def _read_hq_section(reader: StreamReader, count: int, has_off: bool,
                     read_len: int) -> ReadsList:
    """Inverse of encoder._write_hq_section (v1.1 decomposed streams)."""
    from ..streams import mismatch as mm

    order = np.frombuffer(reader.buf[reader.pos : reader.pos + 5], dtype=np.uint8)
    limit = reader.buf[reader.pos + 5]
    rev_offsets = bool(reader.buf[reader.pos + 6])
    reader.pos += 7
    n_streams = (5 if has_off else 4) + limit
    blobs = reader.read_many(n_streams)
    it = iter(blobs)
    if has_off:
        off = np.frombuffer(next(it), dtype=np.uint8).astype(np.int64)
        pos = np.cumsum(off)
    else:
        pos = np.zeros(count, dtype=np.int64)
    rc = np.frombuffer(next(it), dtype=np.uint8).astype(bool)
    nz = np.frombuffer(next(it), dtype=np.uint8).astype(bool)
    cnt_vals = np.frombuffer(next(it), dtype=np.uint8)
    if int(nz.sum()) != cnt_vals.size:
        raise PgtcFormatError("mismatch-count stream desync")
    mis_cnt = np.zeros(count, dtype=np.uint8)
    mis_cnt[nz] = cnt_vals
    exc = np.frombuffer(next(it), dtype=np.uint8)
    off_streams = [next(it) for _ in range(limit)]
    stored = mm.merge_by_count(mis_cnt, off_streams, np.uint8, limit=limit)
    if rev_offsets:
        mis_off = mm.rev_offset_decode(mis_cnt, stored, read_len)
    else:  # -A representation: plain ascending offsets
        mis_off = stored
    return ReadsList(
        pos=pos, org_idx=np.zeros(0, dtype=np.int64), rev_comp=rc,
        mis_cnt=mis_cnt, mis_sym_code=exc, mis_off=mis_off,
        mis_dec_lut=mm.exclusive_decode_lut(order),
    )


def _read_plain_pg_section(reader: StreamReader, count: int) -> np.ndarray:
    off = np.frombuffer(reader.read_one(), dtype=np.uint8).astype(np.int64)
    if off.size != count:
        raise PgtcFormatError("reads-offset stream length disagrees with header")
    return np.cumsum(off)


# ---------------------------------------------------------------------------
# output assembly
# ---------------------------------------------------------------------------


def decode_to_matrices(ar: Archive) -> list[np.ndarray]:
    """Decode to output read matrices: [m] for SE modes, [m1, m2] for PE.

    Convenience wrapper over the streaming chunk decoder (one code path for
    both whole-matrix and chunked output)."""
    n_files = 2 if ar.mode in (MODE_PE, MODE_MIN_PE, MODE_ORD_PE) else 1
    parts: list[list[np.ndarray]] = [[] for _ in range(n_files)]
    for fi, mat in iter_decoded_chunks(ar):
        parts[fi].append(mat)
    return [
        np.concatenate(p) if p else np.zeros((0, ar.read_len), dtype=np.uint8)
        for p in parts
    ]


# rows per decode chunk
_DECODE_CHUNK = 1 << 20


def _decode_rows(ar: Archive, joined_rows: np.ndarray,
                 joined_pg: np.ndarray) -> np.ndarray:
    """Reconstruct the given joined-list rows (hq entries, then lq, then n
    raw reads) against the concatenated pg sequence."""
    L = ar.read_len
    out = np.empty((joined_rows.size, L), dtype=np.uint8)
    hq_len = len(ar.hq_pg)
    is_hq = joined_rows < ar.hq_count
    if is_hq.any():
        sel = joined_rows[is_hq]
        rl = ar.hq_reads.take_rows(sel)
        out[is_hq] = reconstruct_at(ar.hq_pg, rl.pos, L, rl)
    raw = ~is_hq
    if raw.any():
        r = joined_rows[raw]
        is_lq = r < ar.hq_count + ar.lq_count
        pos = np.empty(r.size, dtype=np.int64)
        if is_lq.any():
            pos[is_lq] = ar.lq_pos[r[is_lq] - ar.hq_count] + hq_len
        is_n = ~is_lq
        if is_n.any():
            pos[is_n] = (ar.n_pos[r[is_n] - ar.hq_count - ar.lq_count]
                         + hq_len + len(ar.lq_pg))
        out[raw] = reconstruct_at(joined_pg, pos, L)
    return out


def iter_decoded_chunks(ar: Archive, chunk: int = _DECODE_CHUNK):
    """Yield (file_idx, codes[C, L]) chunks in output order — the streaming
    decode path; decode_to_matrices remains the whole-matrix convenience."""
    L = ar.read_len
    joined_pg = np.concatenate([ar.hq_pg, ar.lq_pg, ar.n_pg])
    if ar.mode == MODE_SE:
        total = ar.hq_count + ar.lq_count + ar.n_count
        for lo in range(0, total, chunk):
            rows = np.arange(lo, min(lo + chunk, total), dtype=np.int64)
            yield 0, _decode_rows(ar, rows, joined_pg)
        return
    if ar.mode in (MODE_PE, MODE_MIN_PE):
        order = ar.rl_idx_order
        for fi in (0, 1):
            sel_all = order[fi::2]
            for lo in range(0, sel_all.size, chunk):
                sel = sel_all[lo : lo + chunk]
                mat = _decode_rows(ar, sel, joined_pg)
                if ar.revcomp_pair and fi == 1:
                    is_raw2 = sel >= ar.hq_count
                    mat[is_raw2] = dna.revcomp_rows(mat[is_raw2])
                yield fi, mat
        return
    # ORD modes: positions by original index; hq entry k = k-th hq member
    pos = ar.pos_by_org
    hq_len = len(ar.hq_pg)
    is_hq_all = pos < hq_len
    hq_rank = np.cumsum(is_hq_all) - 1   # entry index for hq members
    n_files = 2 if ar.mode == MODE_ORD_PE else 1
    for fi in range(n_files):
        org = np.arange(fi, pos.size, n_files, dtype=np.int64)
        for lo in range(0, org.size, chunk):
            o = org[lo : lo + chunk]
            p = pos[o]
            mat = reconstruct_at(joined_pg, p, L)
            is_hq = is_hq_all[o]
            if is_hq.any():
                rows = np.nonzero(is_hq)[0]
                rl = ar.hq_reads.take_rows(hq_rank[o[rows]], pos=p[rows])
                mat[rows] = reconstruct_at(joined_pg, p[rows], L, rl)
            if ar.revcomp_pair and fi == 1:
                is_raw2 = ~is_hq
                mat[is_raw2] = dna.revcomp_rows(mat[is_raw2])
            yield fi, mat
