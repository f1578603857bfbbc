"""Hand-written CUDA kernels, each beside its plain PyTorch version.

Every wrapper dispatches on where its tensors live: CPU tensors run the
plain version (the CPU tests and the kernels' reference), CUDA tensors
launch the kernel — with no try and no fallback: a build or launch failure
raises. `launches` counts kernel launches per kernel, per position type
where a kernel has an int64 form (`<name>.int64`, the wide probe of pgs past
2^31 symbols) and per form where a kernel has a row take (`<name>.take`), so
a run can show that its path went through the kernels, and per form where
a kernel has a sharded form (`<name>.sharded`, a mesh round).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

launches = {"verify_best": 0, "verify_best.int64": 0, "index_kmer_hash": 0,
            "index_kmer_hash.int64": 0, "probe_kmer_hash": 0, "sweep_roll_entries": 0,
            "join_carry": 0, "join_carry.int64": 0, "sweep_pair_claim": 0,
            "sweep_full_hashes": 0, "sweep_link_defaults": 0, "sweep_init_links": 0,
            "sweep_compact": 0, "strand_rows": 0, "strand_rows.take": 0,
            "sweep_roll_entries.sharded": 0, "sweep_pair_claim.sharded": 0}
# scratch word of a compacting scan's first total (csrc/seg_scan.cuh
# kTotalsWord): kernel D's entry count (its sharded form's active prefixes
# in the next word), kernel H's three counts
TOTALS_WORD = 1


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def on_cpu(*tensors: torch.Tensor | None) -> bool:
    """True for all-CPU tensors, False for all-CUDA ones; anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        if len({t.device for t in tensors if t is not None}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(kinds)}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless `t` has `dtype`, `shape` (None = any extent) and is
    contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d
                                    for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def scan_tile() -> int:
    """Entries per tile of the one-pass scans (csrc/seg_scan.cuh, through
    the kernel library)."""
    return build.lib().pgrc_seg_scan_tile()


def scan_scratch(m: int, device: torch.device) -> torch.Tensor:
    """int64 scratch of a one-pass scan over m entries: a tile counter, the
    totals and one look-back descriptor per tile, sized by csrc/seg_scan.cuh.
    Left uninitialised: the kernel's entry point zeroes it on its stream."""
    words = build.lib().pgrc_seg_scan_scratch_words(m)
    return torch.empty((words,), dtype=torch.int64, device=device)


def launch(entry: str, device: torch.device, *args) -> None:
    """Call a C entry point on `device` and PyTorch's current stream there;
    raise if it reports a CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else torch.cuda.current_device()
    err = getattr(build.lib(), entry)(index, ctypes.c_void_p(stream), *args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
