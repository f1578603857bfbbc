"""Native (C++) fast paths, loaded via ctypes.

The reference links vendored C coders directly (coders/rangecoder/*,
coders/lzma/*); we compile our own translation units into one shared object
at first use (g++ is in the image, pybind11 is not — hence ctypes). Every
native routine is bit-compatible with a pure-Python reference implementation
that remains the fallback when no compiler is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

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
_lib_failed = False


def _build() -> bool:
    srcs_mtime = max(os.path.getmtime(s) for s in _SOURCES)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= srcs_mtime:
        return True
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread",
             "-o", _SO + ".tmp", *_SOURCES],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(_SO + ".tmp", _SO)
        return True
    except Exception:
        return False


def get_lib():
    """The loaded shared object, or None when native is unavailable."""
    global _lib_handle, _lib_failed
    if _lib_handle is not None or _lib_failed:
        return _lib_handle
    with _lock:
        if _lib_handle is not None or _lib_failed:
            return _lib_handle
        if not _build():
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _lib_failed = True
            return None
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
            i32p, i32p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), i32p,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pack_lanes_u32.restype = None
        lib.pack_lanes_u32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
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
            u8p, i64p, u8p, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, u8p, u8p, u8p]
        lib.pg_find_matches.restype = ctypes.c_int64
        lib.pg_find_matches.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, i64p, i64p, ctypes.c_int64,
        ]
        _lib_handle = lib
    return _lib_handle


def _u8p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def fastq_parse(buf: bytes):
    """Parse a FASTQ buffer -> (codes [N,L] uint8, quality [N,L] uint8) or
    None when native is unavailable or the input is irregular."""
    import numpy as np

    lib = get_lib()
    if lib is None or not buf:
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

    Returns (n_parsed, bytes_consumed) or None when native is unavailable.
    With final_win=False a trailing partial record is left unconsumed for
    the caller to carry into the next window."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
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
    native is unavailable (caller falls back to the numpy path)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
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
    if lib is None or not buf:
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


def reads_write_lines(codes) -> bytes | None:
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, L = codes.shape
    out = np.empty(n * (L + 1), dtype=np.uint8)
    lib.reads_write_lines(_u8p(codes), n, L, _u8p(out))
    return out.tobytes()


def rc_encode(data: bytes, order: int, period: int, nsym: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + len(data) // 8 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.rc_encode(data, len(data), order, period, nsym, out, cap)
    if n < 0:
        return None
    return out.raw[:n]


def rans_encode(data: bytes) -> bytes | None:
    """Static order-0 rANS encode (the FSE role); None without native."""
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + len(data) // 4 + 1024
    out = ctypes.create_string_buffer(cap)
    n = lib.rans_encode(data, len(data), out, cap)
    if n < 0:
        return None
    return out.raw[:n]


def rans_decode(data: bytes, count: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(max(count, 1))
    n = lib.rans_decode(data, len(data), count, out)
    if n < 0:
        raise ValueError("malformed rANS stream")
    return out.raw[:count]


def pair_walk_decode(offs):
    """offs: int64 numpy array of per-pair offsets -> int64 order array
    [2*n_pairs], or None when native is unavailable / input malformed."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    out = np.empty(offs.size * 2, dtype=np.int64)
    rc = lib.pair_walk_decode(
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), offs.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out


def pack_lanes(codes, lanes_out, nmask_out) -> bool:
    """Pack [n, L] u8 codes into pre-allocated u32 lane matrices (see
    core/packed.pack_lanes). Returns False when native is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, L = codes.shape
    lib.pack_lanes_u32(
        _u8p(codes), n, L, lanes_out.shape[1],
        lanes_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nmask_out.shape[1] if nmask_out is not None else 0,
        nmask_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
        if nmask_out is not None else None,
    )
    return True


def chain_walk_assemble(succ, ovl, codes):
    """Cycle removal + chain layout + pg assembly (sequential native pass,
    the reference's assemblePseudoGenomeTemplate role). Returns
    (pos [n] i64, order [n] i32, pg u8) or None when native is unavailable
    or the links are corrupt. succ/ovl are not mutated (copies passed)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    succ = np.ascontiguousarray(succ, dtype=np.int32).copy()
    ovl = np.ascontiguousarray(ovl, dtype=np.int32).copy()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, L = codes.shape
    i32p = ctypes.POINTER(ctypes.c_int32)
    cuts = lib.cut_cycles(succ.ctypes.data_as(i32p), ovl.ctypes.data_as(i32p), n)
    if cuts < 0:
        return None
    pg_len = int(n * L - ovl[succ >= 0].sum(dtype=np.int64))
    pos = np.empty(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int32)
    pg = np.empty(pg_len, dtype=np.uint8)
    got = lib.chain_walk_assemble(
        succ.ctypes.data_as(i32p), ovl.ctypes.data_as(i32p), _u8p(codes),
        n, L, pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        order.ctypes.data_as(i32p), _u8p(pg),
    )
    if got != pg_len:
        return None
    return pos, order, pg


def pg_find_matches(src, query, min_len: int, k: int, k1: int, k2: int,
                    max_bucket: int = 16):
    """Maximal exact matches (>= min_len) of query vs src (sequential native
    MEM scan; see pgmatch.cpp). Returns [M, 3] (src_pos, query_pos, length)
    int64 or None when native is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.uint8)
    query = np.ascontiguousarray(query, dtype=np.uint8)
    cap = 4096
    i64p = ctypes.POINTER(ctypes.c_int64)
    while True:
        spos = np.empty(cap, dtype=np.int64)
        qpos = np.empty(cap, dtype=np.int64)
        lens = np.empty(cap, dtype=np.int64)
        m = lib.pg_find_matches(
            _u8p(src), src.size, _u8p(query), query.size,
            min_len, k, k1, k2, max_bucket,
            spos.ctypes.data_as(i64p), qpos.ctypes.data_as(i64p),
            lens.ctypes.data_as(i64p), cap,
        )
        if m >= 0:
            return np.stack([spos[:m], qpos[:m], lens[:m]], axis=1)
        cap *= 4


def rcx_encode(data: bytes, nsym: int, order: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + len(data) // 8 + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.rcx_encode(data, len(data), nsym, order, out, cap)
    if n < 0:
        return None
    return out.raw[:n]


def rcx_decode(data: bytes, count: int, nsym: int, order: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(count if count else 1)
    n = lib.rcx_decode(data, len(data), count, nsym, order, out)
    if n != count:
        return None
    return out.raw[:count]


def rc_decode(data: bytes, count: int, order: int, period: int, nsym: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(count if count else 1)
    n = lib.rc_decode(data, len(data), count, order, period, nsym, out)
    if n != count:
        return None
    return out.raw[:count]


def extract_mismatches(pg, pos, rc, codes, max_mis: int):
    """Native matched-read mismatch extraction (window rebuild + compare).

    Returns (mis_cnt uint8 [n], sym flat uint8, off flat uint8) or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n, L = codes.shape
    if n == 0:
        z = np.zeros(0, dtype=np.uint8)
        return z, z.copy(), z.copy()
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    rc_a = np.ascontiguousarray(rc, dtype=np.uint8)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    cnt = np.zeros(n, dtype=np.uint8)
    sym2 = np.empty((n, max_mis), dtype=np.uint8)
    off2 = np.empty((n, max_mis), dtype=np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    total = lib.extract_mismatches_mt(
        _u8p(pg), pos.ctypes.data_as(i64p), _u8p(rc_a), _u8p(codes),
        n, L, max_mis, _u8p(cnt), _u8p(sym2), _u8p(off2))
    if total < 0:
        return None
    keep = np.arange(max_mis, dtype=np.int64)[None, :] < cnt[:, None]
    return cnt, sym2[keep], off2[keep]
