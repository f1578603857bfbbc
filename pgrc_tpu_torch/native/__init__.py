"""Native (C++) host routines, loaded via ctypes.

The reference links vendored C coders directly (coders/rangecoder/*,
coders/lzma/*); we compile our own translation units into one shared object
at first use (g++ is in the image, pybind11 is not — hence ctypes). The
library is required, as the CUDA kernel library is: `get_lib()` raises when
it cannot be built or loaded, and so does every wrapper. A wrapper returns
None only for input its C++ routine rejects (an irregular FASTQ, corrupt
links, a coder's overflowing buffer, a malformed stream), where its caller
takes the Python path.
"""
from __future__ import annotations

import ctypes
import itertools
import os
import subprocess
import threading
import weakref

from ..utils import trace

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libpgrc_native.so")
_SOURCES = [os.path.join(_HERE, "rangecoder.cpp"),
            os.path.join(_HERE, "pairwalk.cpp"),
            os.path.join(_HERE, "fastqio.cpp"),
            os.path.join(_HERE, "packcodes.cpp"),
            os.path.join(_HERE, "chainwalk.cpp"),
            os.path.join(_HERE, "decode.cpp"),
            os.path.join(_HERE, "pgmatch.cpp"),
            os.path.join(_HERE, "rans.cpp")]

_lock = threading.Lock()
_lib_handle = None


def _build(so: str, sources) -> str:
    """Make `so` from `sources` unless it is newer than all of them, and
    return its path; raise RuntimeError, with g++'s errors, when it cannot
    be made. One process at a time checks and builds (an flock on
    `so`.lock), into a file of its own that is renamed into place, so no
    process ever loads a half-written library, and one that waited finds it
    built."""
    import fcntl

    with open(so + ".lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        srcs_mtime = max(os.path.getmtime(s) for s in sources)
        if os.path.exists(so) and os.path.getmtime(so) >= srcs_mtime:
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                 "-pthread", "-o", tmp, *sources],
                check=True, capture_output=True, text=True, timeout=120,
            )
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError) as e:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ could not build {so}: "
                               f"{getattr(e, 'stderr', None) or e}") from e
        return so


def get_lib():
    """The loaded shared object, built at first use; raises RuntimeError
    when it cannot be built or loaded."""
    return _lib_handle if _lib_handle is not None else _load()


def _load():
    global _lib_handle
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        so = _build(_SO, _SOURCES)
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            raise RuntimeError(f"the native library {so} does not load: {e}") from e
        lib.rc_encode.restype = ctypes.c_int64
        lib.rc_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.rc_decode.restype = ctypes.c_int64
        lib.rc_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.rans_encode.restype = ctypes.c_int64
        lib.rans_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.rans_decode.restype = ctypes.c_int64
        lib.rans_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
        ]
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.cut_cycles.restype = ctypes.c_int64
        lib.cut_cycles.argtypes = [i32p, i32p, ctypes.c_int64]
        lib.chain_walk_assemble.restype = ctypes.c_int64
        lib.chain_walk_assemble.argtypes = [
            i32p, i32p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pack_lanes_u32.restype = ctypes.c_int64
        lib.pack_lanes_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.rcx_encode.restype = ctypes.c_int64
        lib.rcx_encode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.rcx_decode.restype = ctypes.c_int64
        lib.rcx_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p,
        ]
        lib.pair_walk_decode.restype = ctypes.c_int32
        lib.pair_walk_decode.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.fastq_parse.restype = ctypes.c_int64
        lib.fastq_parse.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                    i64p, u8p, u8p]
        lib.fastq_parse_mt.restype = ctypes.c_int64
        lib.fastq_parse_mt.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                       i64p, u8p, u8p]
        lib.fastq_parse_div_mt.restype = ctypes.c_int64
        lib.fastq_parse_div_mt.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, u8p, u8p, u8p, i64p]
        lib.lines_parse.restype = ctypes.c_int64
        lib.lines_parse.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                    i64p, u8p]
        lib.reads_write_lines.restype = None
        lib.reads_write_lines.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u8p]
        lib.reconstruct_lines_mt.restype = ctypes.c_int64
        lib.reconstruct_lines_mt.argtypes = [
            u8p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
            u8p, i64p, u8p, u8p, u8p, u8p]
        lib.extract_mismatches_mt.restype = ctypes.c_int64
        lib.extract_mismatches_mt.argtypes = [
            u8p, i64p, u8p, u8p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, u8p, u8p, u8p]
        lib.pg_index_build.restype = ctypes.c_void_p
        lib.pg_index_build.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64]
        lib.pg_index_free.restype = None
        lib.pg_index_free.argtypes = [ctypes.c_void_p]
        lib.pg_scan.restype = ctypes.c_void_p
        lib.pg_scan.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p,
        ]
        lib.pg_runs_take.restype = None
        lib.pg_runs_take.argtypes = [ctypes.c_void_p, i64p]
        _lib_handle = lib
    return _lib_handle


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ids(rows, n_rows: int):
    """(int64 array or None, its pointer or NULL) for an optional row-id
    argument of the native gathers, whose matrix has n_rows rows; an id out
    of range raises before any native code reads through it."""
    i64p = ctypes.POINTER(ctypes.c_int64)
    if rows is None:
        return None, ctypes.cast(None, i64p)
    import numpy as np

    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise IndexError(f"row ids outside [0, {n_rows})")
    return rows, rows.ctypes.data_as(i64p)


def fastq_parse(buf: bytes):
    """Parse a FASTQ buffer -> (codes [N,L] uint8, quality [N,L] uint8) or
    None when the input is empty or irregular."""
    import numpy as np

    lib = get_lib()
    if not buf:
        return None
    # upper bound on reads: every record is >= 7 bytes ('@\nA\n+\nI\n')
    max_reads = len(buf) // 7 + 1
    rl = ctypes.c_int64(0)
    bview = np.frombuffer(buf, dtype=np.uint8)
    # probe first record length to size the matrices tightly
    first_nl = buf.find(b"\n")
    second_nl = buf.find(b"\n", first_nl + 1)
    if first_nl < 0 or second_nl < 0:
        return None
    L = second_nl - first_nl - 1
    approx = len(buf) // (L * 2 + 6) + 2
    codes = np.empty((approx, L), dtype=np.uint8)
    qual = np.empty((approx, L), dtype=np.uint8)
    rl.value = L
    n = lib.fastq_parse_mt(_u8p(bview), len(buf), approx, ctypes.byref(rl),
                           _u8p(codes), _u8p(qual))
    if n < 0:
        return None
    return codes[:n].copy(), qual[:n].copy()


def fastq_parse_div_into(buf, read_len: int, qcol: int, final_win: bool,
                         codes, hq_flag, n_flag, row_off: int,
                         revcomp: bool = False, row_step: int = 1):
    """Windowed FASTQ parse + stage-1 division INTO preallocated arrays
    (codes [cap, L] u8, hq_flag/n_flag [cap] u8), writing read r to codes
    row `row_off + r * row_step` (row_step=2 fills one parity of a
    pair-interleaved matrix directly) and flags to `hq/n[row_off_flag + r]`
    where the flag arrays are indexed densely from row_off // row_step.
    With revcomp, reads are written reverse-complemented (fused).

    Returns (n_parsed, bytes_consumed) or None when the window is
    irregular. With final_win=False a trailing partial record is left
    unconsumed for the caller to carry into the next window."""
    import numpy as np

    lib = get_lib()
    n = len(buf)
    if n == 0:
        return 0, 0
    bview = np.frombuffer(buf, dtype=np.uint8)
    L = codes.shape[1]
    rl = ctypes.c_int64(read_len)
    consumed = ctypes.c_int64(0)
    cap = (codes.shape[0] - row_off + row_step - 1) // row_step
    flag_off = row_off // row_step
    base = codes.ctypes.data + row_off * codes.strides[0]
    r = lib.fastq_parse_div_mt(
        _u8p(bview), n, cap, ctypes.byref(rl), qcol,
        1 if final_win else 0, 1 if revcomp else 0,
        row_step * codes.strides[0],
        ctypes.cast(base, ctypes.POINTER(ctypes.c_uint8)),
        hq_flag[flag_off:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_flag[flag_off:].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(consumed),
    )
    if r < 0:
        return None
    return int(r), int(consumed.value)


def reconstruct_lines(pg, pos, read_len: int, rc=None, mis_cum=None,
                      mis_sym=None, mis_off=None, dec_lut=None):
    """Fused decode: pg windows -> rc -> mismatches -> ASCII lines.

    Returns the line bytes ([n*(L+1)] with trailing newlines) or None when
    the C++ pass rejects its input (caller falls back to the numpy path)."""
    import numpy as np

    lib = get_lib()
    n = pos.shape[0]
    L = read_len
    out = np.empty(n * (L + 1), dtype=np.uint8)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)

    def p8(a):
        return a.ctypes.data_as(u8) if a is not None else ctypes.cast(None, u8)

    rc_a = np.ascontiguousarray(rc, dtype=np.uint8) if rc is not None else None
    cum_a = (np.ascontiguousarray(mis_cum, dtype=np.int64)
             if mis_cum is not None else None)
    sym_a = (np.ascontiguousarray(mis_sym, dtype=np.uint8)
             if mis_sym is not None else None)
    off_a = (np.ascontiguousarray(mis_off, dtype=np.uint8)
             if mis_off is not None else None)
    lut_a = (np.ascontiguousarray(dec_lut, dtype=np.uint8)
             if dec_lut is not None else None)
    r = lib.reconstruct_lines_mt(
        p8(pg), pg.shape[0], pos.ctypes.data_as(i64p), n, L, p8(rc_a),
        cum_a.ctypes.data_as(i64p) if cum_a is not None
        else ctypes.cast(None, i64p),
        p8(sym_a), p8(off_a), p8(lut_a), p8(out))
    if r != 0:
        return None
    return out


def lines_parse(buf: bytes, read_len: int = 0):
    import numpy as np

    lib = get_lib()
    if not buf:
        return None
    if read_len == 0:
        first_nl = buf.find(b"\n")
        read_len = first_nl if first_nl > 0 else len(buf)
    approx = len(buf) // (read_len + 1) + 2
    codes = np.empty((approx, read_len), dtype=np.uint8)
    rl = ctypes.c_int64(read_len)
    bview = np.frombuffer(buf, dtype=np.uint8)
    n = lib.lines_parse(_u8p(bview), len(buf), approx, ctypes.byref(rl), _u8p(codes))
    if n < 0:
        return None
    return codes[:n].copy()


def reads_write_lines(codes) -> bytes:
    import numpy as np

    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, L = codes.shape
    out = np.empty(n * (L + 1), dtype=np.uint8)
    lib.reads_write_lines(_u8p(codes), n, L, _u8p(out))
    return out.tobytes()


def rc_encode(data: bytes, order: int, period: int, nsym: int) -> bytes | None:
    lib = get_lib()
    cap = len(data) + len(data) // 8 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.rc_encode(data, len(data), order, period, nsym, out, cap)
    if n < 0:
        return None
    return out.raw[:n]


def rans_encode(data: bytes) -> bytes | None:
    """Static order-0 rANS encode (the FSE role); None when the output
    overflows its buffer."""
    lib = get_lib()
    cap = len(data) + len(data) // 4 + 1024
    out = ctypes.create_string_buffer(cap)
    n = lib.rans_encode(data, len(data), out, cap)
    if n < 0:
        return None
    return out.raw[:n]


def rans_decode(data: bytes, count: int) -> bytes:
    lib = get_lib()
    out = ctypes.create_string_buffer(max(count, 1))
    n = lib.rans_decode(data, len(data), count, out)
    if n < 0:
        raise ValueError("malformed rANS stream")
    return out.raw[:count]


def pair_walk_decode(offs):
    """offs: int64 numpy array of per-pair offsets -> int64 order array
    [2*n_pairs], or None when the offsets are malformed."""
    import numpy as np

    lib = get_lib()
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    out = np.empty(offs.size * 2, dtype=np.int64)
    rc = lib.pair_walk_decode(
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), offs.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out


def pack_lanes(codes, lanes_out, nmask_out, rows=None):
    """Pack [n, L] u8 codes, or the rows `rows` ([n] ids) of a [*, L]
    matrix, into pre-allocated u32 lane matrices (see
    core/packed_host.pack_lanes); either output may be None. Returns the
    number of packed rows holding an N."""
    import numpy as np

    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    rows, rows_p = _ids(rows, codes.shape[0])
    n = codes.shape[0] if rows is None else rows.size
    u32p = ctypes.POINTER(ctypes.c_uint32)
    return int(lib.pack_lanes_u32(
        _u8p(codes), rows_p, n, codes.shape[1],
        lanes_out.shape[1] if lanes_out is not None else 0,
        lanes_out.ctypes.data_as(u32p) if lanes_out is not None
        else ctypes.cast(None, u32p),
        nmask_out.shape[1] if nmask_out is not None else 0,
        nmask_out.ctypes.data_as(u32p) if nmask_out is not None
        else ctypes.cast(None, u32p),
    ))


def chain_walk_assemble(succ, ovl, codes, rows=None):
    """Cycle removal + chain layout + pg assembly (sequential native pass,
    the reference's assemblePseudoGenomeTemplate role); read x is row x of
    `codes`, or row rows[x] with `rows`. Returns (pos [n] i64 in pg order,
    order [n] i64, pg u8) or None when the links are corrupt. succ/ovl are
    not mutated (copies passed)."""
    import numpy as np

    lib = get_lib()
    succ = np.ascontiguousarray(succ, dtype=np.int32).copy()
    ovl = np.ascontiguousarray(ovl, dtype=np.int32).copy()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    rows, rows_p = _ids(rows, codes.shape[0])
    n, L = succ.size, codes.shape[1]
    i32p = ctypes.POINTER(ctypes.c_int32)
    cuts = lib.cut_cycles(succ.ctypes.data_as(i32p), ovl.ctypes.data_as(i32p), n)
    if cuts < 0:
        return None
    pg_len = int(n * L - ovl[succ >= 0].sum(dtype=np.int64))
    pos = np.empty(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    pg = np.empty(pg_len, dtype=np.uint8)
    got = lib.chain_walk_assemble(
        succ.ctypes.data_as(i32p), ovl.ctypes.data_as(i32p), _u8p(codes),
        rows_p, n, L, pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _u8p(pg),
    )
    if got != pg_len:
        return None
    return pos, order, pg


# a stage-7 scan's threads: at most SCAN_THREADS_MAX (decode.cpp's cap),
# and one for every SCAN_MIN_PROBES probes of its query
SCAN_THREADS_MAX = 16
SCAN_MIN_PROBES = 1 << 18


def scan_threads(nq: int, k: int, k2: int) -> int:
    """The threads a scan of an nq-symbol query probed every k2 takes: the
    CPUs this process may run on less one for the main thread, capped by
    SCAN_THREADS_MAX and by the query's probes over SCAN_MIN_PROBES, and at
    least one."""
    probes = (nq - k) // k2 + 1 if nq >= k else 0
    cpus = len(os.sched_getaffinity(0)) - 1
    return max(1, min(cpus, SCAN_THREADS_MAX, probes // SCAN_MIN_PROBES))


class PgIndex:
    """pgmatch.cpp's sampled k-mer index of one source pg (its CSR bucket
    table of the k-mers at every k1-th position), built once and scanned by
    any number of queries (`find_matches`, from any thread). It reads
    through `src`, which it holds until `close()` (or its collection)
    frees the native table. Each build counts `pgmatch.index_builds`, each
    scan after its first `pgmatch.index_reuses`."""

    def __init__(self, lib, src, k: int, k1: int):
        import numpy as np

        self.src = np.ascontiguousarray(src, dtype=np.uint8)
        handle = lib.pg_index_build(_u8p(self.src), self.src.size, k, k1)
        if not handle:
            raise MemoryError("pg index build: out of memory")
        self._lib, self._handle = lib, handle
        self._scans = itertools.count()
        self._free = weakref.finalize(self, lib.pg_index_free, handle)
        trace.count("pgmatch.index_builds")

    def close(self) -> None:
        self._free()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def find_matches(self, query, min_len: int, k2: int, max_bucket: int,
                     threads: int):
        """Maximal exact matches (>= min_len) of query vs the index's src
        through the anchors probed every k2 (at most max_bucket candidates a
        probe), over `threads` slices of the probes (`scan_threads`).
        -> [M, 3] (src_pos, query_pos, length) int64, sorted and unique:
        the same rows at any thread count."""
        import numpy as np

        if not self._free.alive:
            raise ValueError("scan of a closed pg index")
        query = np.ascontiguousarray(query, dtype=np.uint8)
        if next(self._scans):
            trace.count("pgmatch.index_reuses")
        i64p = ctypes.POINTER(ctypes.c_int64)
        count = ctypes.c_int64(0)
        runs = self._lib.pg_scan(self._handle, _u8p(query), query.size, min_len,
                                 k2, max_bucket, threads, ctypes.byref(count))
        if not runs:
            raise MemoryError("pg scan: out of memory")
        out = np.empty((count.value, 3), dtype=np.int64)
        self._lib.pg_runs_take(runs, out.ctypes.data_as(i64p))
        return out


def pg_index(src, k: int, k1: int):
    """A `PgIndex` of src."""
    return PgIndex(get_lib(), src, k, k1)


def rcx_encode(data: bytes, nsym: int, order: int) -> bytes | None:
    lib = get_lib()
    cap = len(data) + len(data) // 8 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.rcx_encode(data, len(data), nsym, order, out, cap)
    if n < 0:
        return None
    return out.raw[:n]


def rcx_decode(data: bytes, count: int, nsym: int, order: int) -> bytes | None:
    lib = get_lib()
    out = ctypes.create_string_buffer(count if count else 1)
    n = lib.rcx_decode(data, len(data), count, nsym, order, out)
    if n != count:
        return None
    return out.raw[:count]


def rc_decode(data: bytes, count: int, order: int, period: int, nsym: int) -> bytes | None:
    lib = get_lib()
    out = ctypes.create_string_buffer(count if count else 1)
    n = lib.rc_decode(data, len(data), count, order, period, nsym, out)
    if n != count:
        return None
    return out.raw[:count]


# rows of one call of the native mismatch extractor
EXTRACT_CHUNK_ROWS = 1 << 20


def extract_mismatches(pg, pos, rc, codes, max_mis: int, rows=None,
                       flip_odd: bool = False):
    """Native matched-read mismatch extraction (window rebuild + compare).
    Read r is row r of `codes`, or row rows[r] with `rows`; with flip_odd
    a read of odd id is reverse complemented first (the final-output
    orientation of a -r matrix's pair-file reads).

    Returns (mis_cnt uint8 [n], sym flat uint8, off flat uint8), or None
    when the C++ pass rejects its input."""
    import numpy as np

    lib = get_lib()
    rows, _ = _ids(rows, codes.shape[0])
    n, L = codes.shape[0] if rows is None else rows.size, codes.shape[1]
    if n == 0:
        z = np.zeros(0, dtype=np.uint8)
        return z, z.copy(), z.copy()
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    rc_a = np.ascontiguousarray(rc, dtype=np.uint8)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    cnt = np.zeros(n, dtype=np.uint8)
    # a chunk of rows at a time, so the [rows, max_mis] buffers stay small
    chunk = min(n, EXTRACT_CHUNK_ROWS)
    sym2 = np.empty((chunk, max_mis), dtype=np.uint8)
    off2 = np.empty((chunk, max_mis), dtype=np.uint8)
    slots = np.arange(max_mis, dtype=np.int64)[None, :]
    i64p = ctypes.POINTER(ctypes.c_int64)
    syms, offs = [], []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        total = lib.extract_mismatches_mt(
            _u8p(pg), pos[lo:hi].ctypes.data_as(i64p), _u8p(rc_a[lo:hi]),
            _u8p(codes[lo:hi] if rows is None else codes),
            ctypes.cast(None, i64p) if rows is None else rows[lo:hi].ctypes.data_as(i64p),
            1 if flip_odd else 0, hi - lo, L, max_mis,
            _u8p(cnt[lo:hi]), _u8p(sym2), _u8p(off2))
        if total < 0:
            return None
        keep = slots < cnt[lo:hi, None]
        syms.append(sym2[:hi - lo][keep])
        offs.append(off2[:hi - lo][keep])
    return cnt, np.concatenate(syms), np.concatenate(offs)
