"""Build the CUDA kernels in `csrc/` and load them with ctypes.

`nvcc -gencode arch=compute_90a,code=sm_90a` compiles every `csrc/*.cu`
(one nvcc per source, all started together; they include `csrc/*.cuh`) and
links the objects into one shared library with a plain C interface, in
`build/` beside this file, named by a hash of the flags, the sources and
the headers: a changed source or header builds anew, an unchanged tree
loads the library already there. Nothing is built when this
module is imported; the first kernel launch (or an explicit `build()`) runs
nvcc. Each kernel entry point returns the `cudaError_t` of its launch; the
geometry queries (`QUERIES`) return the scans' tile and scratch sizes.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _I64, _U32, _U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_uint32, ctypes.c_uint64)
# entry point -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    "pgrc_verify_best": [_I, _P, _P, _I64, _I, _I, _P, _P, _I, _P, _I64, _I64, _I,
                         _U32, _I, _I, _I, _P, _P],
    "pgrc_index_kmer_hash": [_I, _P, _P, _I64, _I, _I, _I64, _I64, _I64, _U32,
                             _I, _P, _P],
    "pgrc_probe_kmer_hash": [_I, _P, _P, _I64, _I, _P, _I, _I, _I, _U32, _P],
    "pgrc_sweep_roll_entries": [_I, _P, _I64, _P, _I64, _P, _I64, _P, _P, _I, _I,
                                _U64, _U64, _U64, _U64, _P, _P, _P, _P, _P, _P, _P, _I64],
    "pgrc_sweep_roll_records": [_I, _P, _I64, _P, _I64, _P, _I64, _P, _P, _I, _I,
                                _U64, _U64, _U64, _U64, _P, _P, _P, _P, _P, _P, _I64, _P,
                                _I64],
    "pgrc_sweep_full_hashes": [_I, _P, _I64, _P, _I64, _P, _I64, _I, _U64, _U64, _P, _P, _P,
                               _P],
    "pgrc_sweep_link_defaults": [_I, _P, _I64, _P, _P, _P, _P],
    "pgrc_sweep_init_links": [_I, _P, _I64, _P, _P, _P, _I, _P, _P, _P, _P],
    "pgrc_sweep_compact": ([_I, _P, _I64, _P, _I, _I64, _P, _I, _I64] + [_P] * 7
                           + [_P, _I64, _P, _I64] + [_P] * 7 + [_P, _I64]),
    "pgrc_join_carry": [_I, _P, _I64, _P, _P, _P, _I, _P, _P, _I64],
    "pgrc_sweep_pair_claim": [_I, _P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _I, _P, _I64],
    "pgrc_sweep_pair_records": [_I, _P, _I64, _P, _P, _P, _I64, _P, _I, _I64, _I64, _P, _P,
                                _P, _P, _I, _P, _I64],
    "pgrc_sharded_keys": [_I, _P, _I64, _P, _I64, _P, _I, _P],
    "pgrc_strand_rows": [_I, _P, _P, _P, _I, _P, _I64, _I, _P],
}
# geometry queries (no launch): entry point -> (argtypes, restype)
QUERIES = {
    "pgrc_seg_scan_tile": ([], _I64),
    "pgrc_seg_scan_scratch_words": ([_I64], _I64),
    "pgrc_sweep_compact_scratch_words": ([_I64], _I64),
    "pgrc_sweep_compact_tile": ([], _I64),
    "pgrc_sweep_record_chunk": ([], _I64),
}


@dataclass
class Build:
    path: str
    seconds: float      # 0.0 when an up-to-date library was already there
    log: str            # nvcc's output (register and spill report)


_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built on this machine")


def build() -> Build:
    """Compile `csrc/*.cu` unless a library of the same sources and
    headers exists."""
    srcs = sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + headers():
        digest.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"libpgrc_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return Build(so, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.time()
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    log, failed = "", []
    for s, p in zip(srcs, procs):
        out = p.communicate()[0]
        log += out
        if p.returncode != 0:
            failed.append(f"{os.path.basename(s)} ({p.returncode}):\n{out}")
    if not failed:
        link = subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode}):\n{link.stderr}")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return Build(so, time.time() - t0, log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build().path)
            entries = {name: (argtypes, ctypes.c_int) for name, argtypes in SIGNATURES.items()}
            for name, (argtypes, restype) in {**entries, **QUERIES}.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib
