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

Validation mode (reference validateAllPgs/validatePgsOrder,
pgrc-decoder.cpp:552-695) compares against the original inputs instead of
writing output.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import ARCHIVE_MAGIC
from ..config import MODE_SE, MODE_PE, MODE_ORD_SE, MODE_ORD_PE, MODE_MIN_PE
from ..core import fastq, packed
from ..pg.model import ReadsList
from ..pg.reconstruct import reconstruct_at
from ..streams.container import StreamReader
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


def _decode_all_reads(ar: Archive) -> np.ndarray:
    """All reads as one [R_total, L] matrix in joined-list order
    (hq entries, lq pg order, n pg order), rc+mismatch applied to hq."""
    hq = reconstruct_at(ar.hq_pg, ar.hq_reads.pos, ar.read_len, ar.hq_reads)
    lq = reconstruct_at(ar.lq_pg, ar.lq_pos, ar.read_len)
    npg = reconstruct_at(ar.n_pg, ar.n_pos, ar.read_len)
    return np.concatenate([hq, lq, npg], axis=0)


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


# rows per decode chunk: one chunk's [C, L] matrix + formatted bytes stay
# ~200 MB at L=100, and the decode of chunk k+1 overlaps the write of k
# (reference decode threads -> bounded queue -> writer, pgrc-decoder.cpp:
# 100-134, chunk consts pgrc-decoder.h:34-41)
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


def _rows_meta(ar: Archive, joined_rows: np.ndarray):
    """Per-row decode metadata for joined-list rows: absolute positions in
    the joined pg, the hq-row mask, and the hq rows' ReadsList slice."""
    hq_len = len(ar.hq_pg)
    is_hq = joined_rows < ar.hq_count
    pos = np.empty(joined_rows.size, dtype=np.int64)
    rl = None
    if is_hq.any():
        rl = ar.hq_reads.take_rows(joined_rows[is_hq])
        pos[is_hq] = rl.pos
    raw = ~is_hq
    if raw.any():
        r = joined_rows[raw]
        is_lq = r < ar.hq_count + ar.lq_count
        p = np.empty(r.size, dtype=np.int64)
        if is_lq.any():
            p[is_lq] = ar.lq_pos[r[is_lq] - ar.hq_count] + hq_len
        is_n = ~is_lq
        if is_n.any():
            p[is_n] = (ar.n_pos[r[is_n] - ar.hq_count - ar.lq_count]
                       + hq_len + len(ar.lq_pg))
        pos[raw] = p
    return pos, is_hq, rl


def _chunk_lines(ar: Archive, joined_pg: np.ndarray, pos: np.ndarray,
                 is_hq: np.ndarray, rl, flip_raw: bool):
    """Fused native reconstruction of one output chunk to ASCII line bytes;
    returns None when native is unavailable (caller takes the numpy path).

    Touches the output bytes exactly once (window copy + rc + mismatches +
    ASCII in one threaded pass) — the decode analog of the reference's
    chunked writer loops (pgrc-decoder.cpp:137-527)."""
    from .. import native

    n = pos.shape[0]
    rc = np.zeros(n, dtype=np.uint8)
    if flip_raw:
        rc[~is_hq] = 1
    cum = np.zeros(n + 1, dtype=np.int64)
    sym = off = lut = None
    if rl is not None:
        if rl.rev_comp.size:
            rc[is_hq] = rl.rev_comp
        if rl.mis_cnt.size:
            cnts = np.zeros(n, dtype=np.int64)
            cnts[is_hq] = rl.mis_cnt
            np.cumsum(cnts, out=cum[1:])
            sym, off, lut = rl.mis_sym_code, rl.mis_off, rl.mis_dec_lut
            if off.dtype != np.uint8:
                return None  # u16 offsets (L > 256): numpy path
    return native.reconstruct_lines(
        joined_pg, pos, ar.read_len, rc=rc, mis_cum=cum, mis_sym=sym,
        mis_off=off, dec_lut=lut)


def iter_decoded_line_chunks(ar: Archive, chunk: int = _DECODE_CHUNK):
    """Yield (file_idx, line-bytes) chunks in output order via the fused
    native decoder; falls back to formatting the numpy matrices."""
    from ..core import fastq as fastq_mod

    L = ar.read_len
    joined_pg = np.concatenate([ar.hq_pg, ar.lq_pg, ar.n_pg])
    if ar.mode in (MODE_SE, MODE_PE, MODE_MIN_PE):
        if ar.mode == MODE_SE:
            total = ar.hq_count + ar.lq_count + ar.n_count
            plan = [(0, np.arange(lo, min(lo + chunk, total), dtype=np.int64),
                     False) for lo in range(0, total, chunk)]
        else:
            order = ar.rl_idx_order
            plan = []
            for fi in (0, 1):
                sel_all = order[fi::2]
                flip = ar.revcomp_pair and fi == 1
                for lo in range(0, sel_all.size, chunk):
                    plan.append((fi, sel_all[lo : lo + chunk], flip))
        for fi, rows, flip in plan:
            pos, is_hq, rl = _rows_meta(ar, rows)
            data = _chunk_lines(ar, joined_pg, pos, is_hq, rl, flip)
            if data is None:
                mat = _decode_rows(ar, rows, joined_pg)
                if flip:
                    raw = rows >= ar.hq_count
                    mat[raw] = packed.revcomp_codes_matrix(mat[raw])
                data = fastq_mod.reads_lines_bytes(mat)
            yield fi, data
        return
    # ORD modes: positions by original index; hq entry k = k-th hq member
    posall = ar.pos_by_org
    hq_len = len(ar.hq_pg)
    is_hq_all = posall < hq_len
    hq_rank = np.cumsum(is_hq_all) - 1
    n_files = 2 if ar.mode == MODE_ORD_PE else 1
    for fi in range(n_files):
        org = np.arange(fi, posall.size, n_files, dtype=np.int64)
        flip = ar.revcomp_pair and fi == 1
        for lo in range(0, org.size, chunk):
            o = org[lo : lo + chunk]
            p = posall[o]
            is_hq = is_hq_all[o]
            rl = (ar.hq_reads.take_rows(hq_rank[o[is_hq]], pos=p[is_hq])
                  if is_hq.any() else None)
            data = _chunk_lines(ar, joined_pg, p, is_hq, rl, flip)
            if data is None:
                mat = reconstruct_at(joined_pg, p, L)
                if is_hq.any():
                    rows = np.nonzero(is_hq)[0]
                    mat[rows] = reconstruct_at(joined_pg, p[rows], L, rl)
                if flip:
                    mat[~is_hq] = packed.revcomp_codes_matrix(mat[~is_hq])
                data = fastq_mod.reads_lines_bytes(mat)
            yield fi, data


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
                    mat[is_raw2] = packed.revcomp_codes_matrix(mat[is_raw2])
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
                mat[is_raw2] = packed.revcomp_codes_matrix(mat[is_raw2])
            yield fi, mat


def decode_to_files(path: str, out_prefix: str) -> int:
    """Decode archive -> read-line file(s); returns total reads written
    (reference writeAllReadsIn*Mode*, output name convention _out/_out_1/_out_2).

    Streams in bounded chunks through a decode -> format+write pipeline: the
    writer (byte formatting + file IO, GIL-released in the native writer)
    runs one chunk behind the decoder, with backpressure at 2 in-flight
    chunks — the reference's decode-threads/bounded-queue/writer-thread
    design (pgrc-decoder.cpp:100-134) as a two-stage pipeline."""
    from concurrent.futures import ThreadPoolExecutor

    ar = load(path)
    pe = ar.mode in (MODE_PE, MODE_MIN_PE, MODE_ORD_PE)
    names = ([out_prefix + "_out"] if not pe
             else [out_prefix + "_out_1", out_prefix + "_out_2"])
    files = [open(n, "wb") for n in names]
    total = 0
    rec = ar.read_len + 1
    try:
        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = []
            for fi, data in iter_decoded_line_chunks(ar):
                total += len(data) // rec
                pending.append(ex.submit(
                    lambda f, d: f.write(d), files[fi], data))
                while len(pending) > 2:
                    pending.pop(0).result()
            for fut in pending:
                fut.result()
    finally:
        for f in files:
            f.close()
    return total


_FP_B = np.uint64(1099511628211)   # FNV prime — line-hash base
_FP_B2 = np.uint64(0x9E3779B97F4A7C15)  # independent second base
# MurmurHash3's 64-bit finalizer constants
_FMIX1 = np.uint64(0xFF51AFD7ED558CCD)
_FMIX2 = np.uint64(0xC4CEB9FE1A85EC53)


def _fmix64(x: np.ndarray) -> np.ndarray:
    """A bijective, nonlinear mix of u64 values (MurmurHash3's fmix64).

    A line hash is linear in the line's bytes, so a plain sum of line hashes
    cannot tell two reads from the same two reads with bytes of one column
    swapped (both sums move by opposite amounts); a sum of mixed line hashes
    can. The reference validates with the plain sums (its decoder.py:457-474,
    :576-588); the archive bytes do not depend on this."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(33))
        x = x * _FMIX1
        x = x ^ (x >> np.uint64(33))
        x = x * _FMIX2
        return x ^ (x >> np.uint64(33))


def _fp_pows(n: int, base: np.uint64) -> np.ndarray:
    # wraparound mod 2^64 IS the hash ring — silence numpy's scalar
    # overflow warning for the power table
    with np.errstate(over="ignore"):
        p = np.empty(n, dtype=np.uint64)
        p[0] = 1
        for i in range(1, n):
            p[i] = p[i - 1] * base
    return p


class _LineHasher:
    """Streaming per-line 2x64-bit polynomial hashes + multiset sums of
    their nonlinear mixes (`_fmix64`).

    feed() takes byte blocks of newline-terminated lines (uniform length
    within a call is NOT required); per-read hashes can optionally be
    collected for pair-association checks."""

    def __init__(self, keep_hashes: bool = False):
        self.sum1 = np.uint64(0)
        self.sum2 = np.uint64(0)
        self.count = 0
        self.keep = [] if keep_hashes else None
        self._pows1 = _fp_pows(512, _FP_B)
        self._pows2 = _fp_pows(512, _FP_B2)

    _BLOCK = 1 << 16  # lines per hash block: bounds the [B, L] u64 temps

    def feed(self, data: np.ndarray, starts: np.ndarray, ends: np.ndarray):
        for lo in range(0, starts.size, self._BLOCK):
            self._feed_block(data, starts[lo : lo + self._BLOCK],
                             ends[lo : lo + self._BLOCK])

    def _feed_block(self, data, starts, ends):
        if starts.size == 0:
            return
        lw = int((ends - starts).max())
        idx = np.minimum(starts[:, None] + np.arange(lw)[None, :],
                         data.size - 1)
        mat = data[idx].astype(np.uint64)
        mask = np.arange(lw)[None, :] < (ends - starts)[:, None]
        with np.errstate(over="ignore"):
            h1 = (mat * self._pows1[None, :lw] * mask).sum(axis=1,
                                                           dtype=np.uint64)
            h2 = (mat * self._pows2[None, :lw] * mask).sum(axis=1,
                                                           dtype=np.uint64)
            self.sum1 += _fmix64(h1).sum(dtype=np.uint64)
            self.sum2 += _fmix64(h2).sum(dtype=np.uint64)
        self.count += starts.size
        if self.keep is not None:
            self.keep.append((h1, h2))

    def feed_lines(self, buf: bytes, rec_len: int):
        """Uniform newline-terminated records of rec_len+1 bytes."""
        data = np.frombuffer(buf, dtype=np.uint8)
        n = data.size // (rec_len + 1)
        starts = np.arange(n, dtype=np.int64) * (rec_len + 1)
        self.feed(data, starts, starts + rec_len)

    def hashes(self):
        if not self.keep:
            return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
        return (np.concatenate([h for h, _ in self.keep]),
                np.concatenate([h for _, h in self.keep]))

    def state(self):
        return (int(self.sum1), int(self.sum2), self.count)


def _hash_fastq_seq_lines(path: str, hasher: _LineHasher) -> None:
    """Stream a FASTQ/FASTA/lines file, feeding only the sequence lines."""
    with open(path, "rb") as f:
        head = f.read(1)
        f.seek(0)
        rec_lines, seq_line = 1, 0
        if head == b"@":
            rec_lines, seq_line = 4, 1
        elif head == b">":
            rec_lines, seq_line = 2, 1
        rem = b""
        lineno = 0
        while True:
            block = f.read(1 << 25)
            if not block and not rem:
                break
            buf = rem + block if block else rem
            if block:
                cut = buf.rfind(b"\n") + 1
                rem = buf[cut:]
                buf = buf[:cut]
            else:
                rem = b""
                if not buf.endswith(b"\n"):
                    buf += b"\n"
            data = np.frombuffer(buf, dtype=np.uint8)
            ends = np.nonzero(data == 10)[0]
            if ends.size == 0:
                continue
            starts = np.concatenate([[0], ends[:-1] + 1])
            sel = (np.arange(lineno, lineno + ends.size) % rec_lines) == seq_line
            lineno += ends.size
            hasher.feed(data, starts[sel], ends[sel])


def validate(path: str, src_fastq: str, pair_fastq: str = "") -> dict:
    """Validation mode (reference -d -i src: validateAllPgs/validatePgsOrder,
    pgrc-decoder.cpp:552-695) — STREAMING: both the archive decode and the
    original file(s) are consumed in bounded chunks (the reference
    validates streaming too, :579-628), so a 100M-read archive validates
    without materializing a read matrix (VERDICT r4 #5).

    Order-preserving modes compare byte-identically; non-ord modes compare
    2x64-bit multiset line fingerprints (plus per-pair association
    fingerprints in PE mode). Each fingerprint sums nonlinear mixes of the
    line hashes and of each pair's two hashes, so a byte swapped between
    two reads, or mates re-matched between pairs, fails. MIN_PE keeps the
    pairs but not the order inside one, so there the two files are one
    multiset and a pair is unordered.
    """
    ar = load(path)
    rec = ar.read_len + 1
    report = {"reads": 0, "errors": 0, "order_exact": True}
    if ar.mode in (MODE_ORD_SE, MODE_ORD_PE):
        # byte-exact streaming compare against the source seq lines
        srcs = [src_fastq] + ([pair_fastq] if pair_fastq else [])
        cmps = [_StreamCompare(p) for p in srcs]
        for fi, data in iter_decoded_line_chunks(ar):
            if isinstance(data, np.ndarray):
                data = data.tobytes()
            report["reads"] += len(data) // rec
            if fi < len(cmps):
                report["errors"] += cmps[fi].feed(data, ar.read_len)
        for c in cmps:
            report["errors"] += c.finish()
        return report
    report["order_exact"] = False
    pe = ar.mode in (MODE_PE, MODE_MIN_PE) and bool(pair_fastq)
    got = [_LineHasher(keep_hashes=pe), _LineHasher(keep_hashes=pe)]
    for fi, data in iter_decoded_line_chunks(ar):
        if isinstance(data, np.ndarray):
            data = data.tobytes()
        report["reads"] += len(data) // rec
        got[fi].feed_lines(data, ar.read_len)
    want = [_LineHasher(keep_hashes=pe), _LineHasher(keep_hashes=pe)]
    _hash_fastq_seq_lines(src_fastq, want[0])
    if pair_fastq:
        _hash_fastq_seq_lines(pair_fastq, want[1])
    if pair_fastq and ar.mode == MODE_SE:
        # -S archives drop pair structure: compare the combined multiset
        _hash_fastq_seq_lines(pair_fastq, want[0])
        want[1] = _LineHasher()
    unordered = ar.mode == MODE_MIN_PE and bool(pair_fastq)
    if unordered:
        # one multiset over both files: a read may leave in either
        merged = [tuple(x % (1 << 64) for x in map(sum, zip(h[0].state(), h[1].state())))
                  for h in (got, want)]
        report["errors"] += int(merged[0] != merged[1])
    else:
        for g, w in zip(got, want):
            if g.state() != w.state():
                report["errors"] += 1
    if pe:
        # pair association: multiset of each pair's (read1, read2) hashes,
        # mixed together nonlinearly (in MIN_PE the lower hash first)
        def pair_fp(h):
            a1, a2 = h[0].hashes()
            b1, b2 = h[1].hashes()
            if a1.size != b1.size:
                return None
            if unordered:
                swap = (a1 > b1) | ((a1 == b1) & (a2 > b2))
                a1, b1 = np.where(swap, b1, a1), np.where(swap, a1, b1)
                a2, b2 = np.where(swap, b2, a2), np.where(swap, a2, b2)
            with np.errstate(over="ignore"):
                c1 = _fmix64(_fmix64(a1) * _FP_B + b1)
                c2 = _fmix64(_fmix64(a2) * _FP_B2 + b2)
            return (int(c1.sum(dtype=np.uint64)),
                    int(c2.sum(dtype=np.uint64)), a1.size)

        pg, pw = pair_fp(got), pair_fp(want)
        if pg is None or pw is None or pg != pw:
            report["errors"] += 1
    return report


class _StreamCompare:
    """Byte-exact streaming compare of decoded line chunks against the
    sequence lines of a FASTQ/FASTA/lines file (ORD-mode validation)."""

    def __init__(self, path: str):
        self._gen = self._lines(path)
        self._buf = b""

    def _lines(self, path):
        hasher = None
        with open(path, "rb") as f:
            head = f.read(1)
            f.seek(0)
            rec_lines, seq_line = 1, 0
            if head == b"@":
                rec_lines, seq_line = 4, 1
            elif head == b">":
                rec_lines, seq_line = 2, 1
            rem = b""
            lineno = 0
            while True:
                block = f.read(1 << 25)
                if not block and not rem:
                    break
                buf = rem + block if block else rem
                if block:
                    cut = buf.rfind(b"\n") + 1
                    rem = buf[cut:]
                    buf = buf[:cut]
                else:
                    rem = b""
                    if not buf.endswith(b"\n"):
                        buf += b"\n"
                out = []
                pos = 0
                while True:
                    nl = buf.find(b"\n", pos)
                    if nl < 0:
                        break
                    if lineno % rec_lines == seq_line:
                        out.append(buf[pos : nl + 1])
                    lineno += 1
                    pos = nl + 1
                if out:
                    yield b"".join(out)

    def feed(self, data: bytes, read_len: int) -> int:
        """Compare the next decoded chunk; returns mismatching byte-run
        count (0/1 granularity per chunk)."""
        self._buf += data
        errs = 0
        while self._buf:
            try:
                want = next(self._gen)
            except StopIteration:
                return errs + 1  # more decoded data than source lines
            take = min(len(want), len(self._buf))
            if take < len(want):
                # keep the unconsumed part of the source chunk for later
                self._gen = self._chain(want[take:], self._gen)
            if self._buf[:take] != want[:take]:
                errs += 1
            self._buf = self._buf[take:]
        return errs

    @staticmethod
    def _chain(first: bytes, gen):
        yield first
        yield from gen

    def finish(self) -> int:
        try:
            next(self._gen)
            return 1  # source has lines the decode did not produce
        except StopIteration:
            return 0


def _multiset_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape != b.shape:
        return False
    av = np.ascontiguousarray(a).view([("", a.dtype)] * a.shape[1]).ravel()
    bv = np.ascontiguousarray(b).view([("", b.dtype)] * b.shape[1]).ravel()
    return np.array_equal(np.sort(av), np.sort(bv))
