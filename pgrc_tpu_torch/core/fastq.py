"""Host-side reads IO: FASTQ/FASTA/line formats, pairing, quality division.

Replaces readsset/iterator/ReadsSetIterator.cpp + DivisionReadsSetDecorators.cpp
with vectorized numpy parsing over whole-file buffers (constant-length reads).

Format autodetection mirrors ReadsSetPersistence.cpp:36-47 (first byte:
'@' FASTQ, '>' FASTA, otherwise one read per line).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import dna, trace


@dataclass
class ReadsSet:
    """All reads of one input (or pair-interleaved input) as matrices."""

    codes: np.ndarray          # [N, L] uint8 value codes (0..4)
    quality: np.ndarray | None  # [N, L] uint8 phred+33 bytes, or None
    read_len: int

    @property
    def count(self) -> int:
        return self.codes.shape[0]


def detect_format(path: str) -> str:
    with open(path, "rb") as f:
        first = f.read(1)
    if first == b"@":
        return "fastq"
    if first == b">":
        return "fasta"
    return "lines"


def _split_lines_matrix(buf: bytes):
    """Return (data, line_starts, line_lengths) for a whole-file buffer."""
    data = np.frombuffer(buf, dtype=np.uint8)
    if data.size == 0:
        empty = np.zeros(0, dtype=np.int64)
        return data, empty, empty
    if data[-1] != ord("\n"):
        data = np.concatenate([data, np.array([ord("\n")], dtype=np.uint8)])
    ends = np.nonzero(data == ord("\n"))[0]
    starts = np.concatenate([[0], ends[:-1] + 1])
    lengths = ends - starts
    return data, starts, lengths


def read_fastq(path: str) -> ReadsSet:
    """Parse a FASTQ file of constant-length reads into code/quality matrices."""
    with open(path, "rb") as f:
        buf = f.read()
    from .. import native

    fast = native.fastq_parse(buf)
    if fast is not None:
        codes, quality = fast
        return ReadsSet(codes=codes, quality=quality, read_len=codes.shape[1])
    data, starts, lengths = _split_lines_matrix(buf)
    nlines = starts.size
    if nlines % 4:
        raise ValueError(f"{path}: FASTQ line count {nlines} not divisible by 4")
    n = nlines // 4
    seq_starts = starts[1::4]
    seq_lens = lengths[1::4]
    read_len = int(seq_lens[0])
    if not (seq_lens == read_len).all():
        raise ValueError(f"{path}: variable-length reads unsupported (constant-length model)")
    qual_starts = starts[3::4]
    idx = seq_starts[:, None] + np.arange(read_len)[None, :]
    codes = dna.SYM2VAL[data[idx]]
    quality = data[qual_starts[:, None] + np.arange(read_len)[None, :]]
    return ReadsSet(codes=codes, quality=quality, read_len=read_len)


def read_fasta(path: str) -> ReadsSet:
    with open(path, "rb") as f:
        buf = f.read()
    data, starts, lengths = _split_lines_matrix(buf)
    is_seq = data[starts] != ord(">")
    seq_starts = starts[is_seq]
    seq_lens = lengths[is_seq]
    read_len = int(seq_lens[0])
    if not (seq_lens == read_len).all():
        raise ValueError(f"{path}: variable-length reads unsupported")
    idx = seq_starts[:, None] + np.arange(read_len)[None, :]
    return ReadsSet(codes=dna.SYM2VAL[data[idx]], quality=None, read_len=read_len)


def read_lines(path: str) -> ReadsSet:
    with open(path, "rb") as f:
        buf = f.read()
    data, starts, lengths = _split_lines_matrix(buf)
    keep = lengths > 0
    seq_starts = starts[keep]
    seq_lens = lengths[keep]
    read_len = int(seq_lens[0])
    if not (seq_lens == read_len).all():
        raise ValueError(f"{path}: variable-length reads unsupported")
    idx = seq_starts[:, None] + np.arange(read_len)[None, :]
    return ReadsSet(codes=dna.SYM2VAL[data[idx]], quality=None, read_len=read_len)


def read_any(path: str) -> ReadsSet:
    fmt = detect_format(path)
    if fmt == "fastq":
        return read_fastq(path)
    if fmt == "fasta":
        return read_fasta(path)
    return read_lines(path)


# ---------------------------------------------------------------------------
# streamed (chunked) ingest — the scale path
# ---------------------------------------------------------------------------

# default IO window; one window of FASTQ at 100 bp is ~600k reads
_WINDOW_BYTES = 128 * 1024 * 1024


def _record_lines(fmt: str) -> int:
    return {"fastq": 4, "fasta": 2, "lines": 1}[fmt]


def _parse_window(fmt: str, window: bytes) -> ReadsSet:
    data, starts, lengths = _split_lines_matrix(window)
    if fmt == "fastq":
        from .. import native

        fast = native.fastq_parse(window)
        if fast is not None:
            codes, quality = fast
            return ReadsSet(codes=codes, quality=quality,
                            read_len=codes.shape[1])
        seq_starts, seq_lens = starts[1::4], lengths[1::4]
        qual_starts = starts[3::4]
    elif fmt == "fasta":
        is_seq = data[starts] != ord(">")
        seq_starts, seq_lens = starts[is_seq], lengths[is_seq]
        qual_starts = None
    else:
        keep = lengths > 0
        seq_starts, seq_lens = starts[keep], lengths[keep]
        qual_starts = None
    read_len = int(seq_lens[0])
    if not (seq_lens == read_len).all():
        raise ValueError("variable-length reads unsupported (constant-length model)")
    idx = seq_starts[:, None] + np.arange(read_len)[None, :]
    codes = dna.SYM2VAL[data[idx]]
    quality = None
    if qual_starts is not None:
        quality = data[qual_starts[:, None] + np.arange(read_len)[None, :]]
    return ReadsSet(codes=codes, quality=quality, read_len=read_len)


def iter_reads_chunked(path: str, window_bytes: int = _WINDOW_BYTES):
    """Yield ReadsSet chunks without holding the whole file in memory.

    The reference streams records one at a time through its iterator stack
    (readsset/iterator/ReadsSetIterator.cpp:45-243); here each IO window is
    cut at the last complete record (records are a fixed line count per
    format, so the cut is exact — no content sniffing) and parsed with the
    same vectorized/native parsers as the whole-file path.
    """
    fmt = detect_format(path)
    rec_lines = _record_lines(fmt)
    rem = b""
    with open(path, "rb") as f:
        while True:
            block = f.read(window_bytes)
            if not block:
                break
            buf = rem + block
            data = np.frombuffer(buf, dtype=np.uint8)
            ends = np.nonzero(data == ord("\n"))[0]
            if fmt == "fasta":
                # records are '>' lines: cut before the LAST header line so
                # a possibly multi-line record never splits (constant-length
                # model: one seq line per record, but stay safe)
                nrec = ends.size // rec_lines
            else:
                nrec = ends.size // rec_lines
            if nrec == 0:
                rem = buf
                continue
            cut = int(ends[nrec * rec_lines - 1]) + 1
            rem = buf[cut:]
            yield _parse_window(fmt, buf[:cut])
    if rem.strip():
        yield _parse_window(fmt, rem if rem.endswith(b"\n") else rem + b"\n")


@dataclass
class DividedInput:
    """Streamed stage-1 product: full code matrix + division masks, with
    quality bytes never held beyond one IO window."""

    codes: np.ndarray
    hq_mask: np.ndarray
    n_mask: np.ndarray
    read_len: int

    @property
    def count(self) -> int:
        return self.codes.shape[0]


def _probe_fastq_read_len(path: str) -> int:
    with open(path, "rb") as f:
        head = f.read(65536)
    if head[:1] != b"@":
        return 0
    fn = head.find(b"\n")
    sn = head.find(b"\n", fn + 1) if fn >= 0 else -1
    if fn < 0 or sn < 0:
        return 0
    return sn - fn - 1


def _parse_divided_file_native(path: str, L: int, qcol: int, codes, hq, nf,
                               row_off: int, row_step: int, revcomp: bool,
                               window_bytes: int) -> int | None:
    """Stream one FASTQ through the native divided parser into preallocated
    arrays; returns the number of reads, or None (caller falls back)."""
    import os as _os

    from .. import native

    ba = bytearray(window_bytes + 4096)
    mv = memoryview(ba)
    rem = 0
    rows = 0
    with open(path, "rb") as f:
        while True:
            nread = f.readinto(mv[rem:]) or 0
            total = rem + nread
            if total == 0:
                break
            final = nread < len(ba) - rem
            res = native.fastq_parse_div_into(
                mv[:total], L, qcol, final, codes, hq, nf,
                row_off + rows * row_step, revcomp=revcomp,
                row_step=row_step)
            if res is None:
                return None
            n_parsed, consumed = res
            if n_parsed == 0 and consumed == 0 and total >= len(ba):
                # a partial record filled the whole window (malformed input,
                # e.g. a '@'-leading file with no newlines): no progress is
                # possible — fall back instead of looping forever
                return None
            rows += n_parsed
            rem = total - consumed
            if rem:
                mv[:rem] = mv[consumed:total]
            if final:
                break
    if rem:
        return None  # trailing partial record
    return rows


def _read_divided_native(path: str, pair_path: str | None, revcomp_pair: bool,
                         error_limit: float,
                         window_bytes: int) -> DividedInput | None:
    """No-copy stage-1 ingest: native windowed parse straight into one
    preallocated code matrix (pair files write interleaved parities with
    fused rev-compl), quality reduced to the single classifier byte per
    read during the parse — the full quality matrix never exists. On this
    host memory bandwidth is the encode bottleneck, so the win over the
    generic chunked path is ~4x at 2M reads. The mate file's parse (and
    reverse complement) is the span `input.mate` (attrs `rows`, `revcomp`)."""
    import os as _os

    L = _probe_fastq_read_len(path)
    if L <= 0:
        return None
    qcol = min(int(L * (1.0 - error_limit)), L - 1)
    cap1 = _os.path.getsize(path) // (2 * L + 6) + 2
    if pair_path is None:
        codes = np.empty((cap1, L), dtype=np.uint8)
        hq = np.empty(cap1, dtype=np.uint8)
        nf = np.empty(cap1, dtype=np.uint8)
        n = _parse_divided_file_native(
            path, L, qcol, codes, hq, nf, 0, 1, False, window_bytes)
        if n is None:
            return None
        return DividedInput(codes[:n], hq[:n].view(np.bool_),
                            nf[:n].view(np.bool_), L)
    if _probe_fastq_read_len(pair_path) != L:
        return None
    cap2 = _os.path.getsize(pair_path) // (2 * L + 6) + 2
    cap = max(cap1, cap2)
    codes = np.empty((2 * cap, L), dtype=np.uint8)
    hq1 = np.empty(cap, dtype=np.uint8)
    nf1 = np.empty(cap, dtype=np.uint8)
    hq2 = np.empty(cap, dtype=np.uint8)
    nf2 = np.empty(cap, dtype=np.uint8)
    n1 = _parse_divided_file_native(
        path, L, qcol, codes, hq1, nf1, 0, 2, False, window_bytes)
    if n1 is None:
        return None
    # with rev-compl the stored quality row is reversed too (the chunked
    # path's q2[:, ::-1]); the classifier byte therefore comes from the
    # mirrored column of the raw quality line
    qcol2 = (L - 1 - qcol) if revcomp_pair else qcol
    with trace.span("input.mate", revcomp=revcomp_pair) as sp:
        n2 = _parse_divided_file_native(
            pair_path, L, qcol2, codes, hq2, nf2, 1, 2, revcomp_pair,
            window_bytes)
        sp.attrs["rows"] = n2
    if n2 is None:
        return None
    if n1 != n2:
        raise ValueError(
            f"paired files {path} / {pair_path} have different read counts")
    hq = np.empty(2 * n1, dtype=np.uint8)
    hq[0::2] = hq1[:n1]
    hq[1::2] = hq2[:n1]
    nf = np.empty(2 * n1, dtype=np.uint8)
    nf[0::2] = nf1[:n1]
    nf[1::2] = nf2[:n1]
    return DividedInput(codes[: 2 * n1], hq.view(np.bool_),
                        nf.view(np.bool_), L)


def read_divided(path: str, pair_path: str | None, revcomp_pair: bool,
                 error_limit: float, simplified: bool,
                 window_bytes: int = _WINDOW_BYTES) -> DividedInput:
    """Chunked ingest + quality division in one pass (stage 1 at scale).

    Peak extra memory is one IO window + one chunk's quality matrix; the
    retained state is the [N, L] code matrix and two bit masks. Simplified
    quality mode takes the native fused parse+divide path when available.
    """
    if simplified and detect_format(path) == "fastq" and (
            pair_path is None or detect_format(pair_path) == "fastq"):
        fast = _read_divided_native(path, pair_path, revcomp_pair,
                                    error_limit, window_bytes)
        if fast is not None:
            return fast
    def chunks():
        if pair_path is None:
            for c in iter_reads_chunked(path, window_bytes):
                yield c
            return
        it1 = iter_reads_chunked(path, window_bytes)
        it2 = iter_reads_chunked(path_pair := pair_path, window_bytes)
        buf1 = buf2 = None
        while True:
            # lockstep interleave with re-chunking: files may cut windows at
            # different record counts
            if buf1 is None or buf1.count == 0:
                buf1 = next(it1, None)
            if buf2 is None or buf2.count == 0:
                buf2 = next(it2, None)
            if buf1 is None or buf2 is None:
                if (buf1 is None) != (buf2 is None) and (
                        (buf1 and buf1.count) or (buf2 and buf2.count)):
                    raise ValueError(
                        f"paired files {path} / {path_pair} have different "
                        "read counts")
                return
            k = min(buf1.count, buf2.count)
            c1, c2 = buf1.codes[:k], buf2.codes[:k]
            q1 = buf1.quality[:k] if buf1.quality is not None else None
            q2 = buf2.quality[:k] if buf2.quality is not None else None
            L = c1.shape[1]
            if c2.shape[1] != L:
                raise ValueError("paired files must have equal read lengths")
            codes = np.empty((2 * k, L), dtype=np.uint8)
            codes[0::2] = c1
            codes[1::2] = dna.revcomp_codes(c2, axis=1) if revcomp_pair else c2
            quality = None
            if q1 is not None and q2 is not None:
                quality = np.empty((2 * k, L), dtype=np.uint8)
                quality[0::2] = q1
                quality[1::2] = q2[:, ::-1] if revcomp_pair else q2
            yield ReadsSet(codes=codes, quality=quality, read_len=L)
            buf1 = ReadsSet(buf1.codes[k:],
                            None if q1 is None else buf1.quality[k:], L)
            buf2 = ReadsSet(buf2.codes[k:],
                            None if q2 is None else buf2.quality[k:],
                            c2.shape[1])

    code_parts, hq_parts, n_parts = [], [], []
    read_len = 0
    for chunk in chunks():
        read_len = chunk.read_len
        code_parts.append(chunk.codes)
        hq_parts.append(quality_high_mask(chunk, error_limit, simplified))
        n_parts.append(contains_n_mask(chunk))
    if not code_parts:
        z = np.zeros((0, 0), dtype=np.uint8)
        return DividedInput(z, np.zeros(0, bool), np.zeros(0, bool), 0)
    codes = code_parts[0] if len(code_parts) == 1 else np.concatenate(code_parts)
    return DividedInput(
        codes=codes,
        hq_mask=np.concatenate(hq_parts),
        n_mask=np.concatenate(n_parts),
        read_len=read_len,
    )


def read_paired(path1: str, path2: str, revcomp_pair: bool) -> ReadsSet:
    """Interleave two paired files read1,read2,read1,... (reference
    ReadsSetPersistence::createManagedReadsIterator pairing); optionally
    reverse-complement every second read (RevComplPairReadsSetIterator,
    ReadsSetIterator.cpp:249-287)."""
    r1 = read_any(path1)
    r2 = read_any(path2)
    if r1.read_len != r2.read_len or r1.count != r2.count:
        raise ValueError("paired files must have equal read counts and lengths")
    n, L = r1.codes.shape
    codes = np.empty((2 * n, L), dtype=np.uint8)
    codes[0::2] = r1.codes
    codes[1::2] = dna.revcomp_codes(r2.codes, axis=1) if revcomp_pair else r2.codes
    quality = None
    if r1.quality is not None and r2.quality is not None:
        quality = np.empty((2 * n, L), dtype=np.uint8)
        quality[0::2] = r1.quality
        quality[1::2] = r2.quality[:, ::-1] if revcomp_pair else r2.quality
    return ReadsSet(codes=codes, quality=quality, read_len=L)


def quality_high_mask(
    reads: ReadsSet, error_limit: float, simplified_suffix_mode: bool = True
) -> np.ndarray:
    """Vectorized quality classifier (DivisionReadsSetDecorators.cpp:30-38).

    simplified mode: quality[readLength*(1-error_limit)] > '#'
    full mode: arithmetic mean of per-base correct probability >= 1-error_limit.
    """
    if reads.quality is None:
        return np.ones(reads.count, dtype=bool)
    if simplified_suffix_mode:
        suffix_pos = int(reads.read_len * (1.0 - error_limit))
        suffix_pos = min(suffix_pos, reads.read_len - 1)
        return reads.quality[:, suffix_pos] > ord("#")
    probs = dna.QUALITY2PROB[reads.quality]
    return (1.0 - probs.mean(axis=1)) <= error_limit


def contains_n_mask(reads: ReadsSet) -> np.ndarray:
    return (reads.codes == dna.N).any(axis=1)


def write_reads_lines(path: str, codes: np.ndarray) -> None:
    """Write a [N, L] code matrix as ASCII read lines (decoder output format;
    the reference also emits bare read lines, pgrc-decoder.cpp:160-165)."""
    from .. import native

    with open(path, "wb") as f:
        f.write(native.reads_write_lines(codes))
