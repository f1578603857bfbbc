"""State carried between the reference's numpy world and the port's tensors.

Every device-program input or output of `pgrc_tpu` has a numpy form (what
the host layer produces and consumes) and a tensor form on a device (what
the port's kernels take). These functions move each one across, bit for
bit, in both directions; the parity tests feed the same state through both
packages with them.

Every upload and every device read of the port goes through `to_device`,
`to_host`, `host_int` or `host_ints` (a copy, `int()`, `.tolist()`: the
reads the port makes, each counted where it is made). A copy that crosses
between the host and a CUDA device adds to the open encode's counters
(`utils.trace`): `h2d_bytes` and `h2d_copies` up, `d2h_bytes` and
`device_syncs` down — a read of the card waits for its stream, so each is
one host sync. The helpers add no copy and no sync of their own.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import packed
from .utils import trace, uint


_HOST = torch.device("cpu")


def crosses(src: torch.device, dst: torch.device) -> bool:
    """Whether a copy from `src` to `dst` crosses between the host and a
    CUDA device (what the counters count)."""
    return (src.type == "cuda") != (dst.type == "cuda")


def _count_read(t: torch.Tensor) -> None:
    if crosses(t.device, _HOST):
        trace.count("d2h_bytes", t.nbytes)
        trace.count("device_syncs")


def to_device(a: np.ndarray | torch.Tensor, device) -> torch.Tensor:
    """A host array (as it lies, no copy on the host) or a tensor, on
    `device`."""
    t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    out = t.to(device)
    if crosses(t.device, out.device):
        trace.count("h2d_bytes", t.nbytes)
        trace.count("h2d_copies")
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` on the host: a device read, which waits for the device."""
    _count_read(t)
    return t.cpu()


def host_int(t: torch.Tensor) -> int:
    """The one value of `t`, read to the host."""
    _count_read(t)
    return int(t)


def host_ints(t: torch.Tensor) -> list:
    """The values of `t`, read to the host as Python numbers."""
    _count_read(t)
    return t.tolist()


def lanes_to_device(lanes: np.ndarray, nmask: np.ndarray | None, device):
    """`packed.pack_lanes` output ([n, W+1] u32 lanes, [n, Wn+1] u32 N mask or
    None) -> (int32 lanes, int32 N mask or None) on `device`."""
    lanes_t = uint.np_u32_to_tensor(lanes, device)
    nmask_t = None if nmask is None else uint.np_u32_to_tensor(nmask, device)
    return lanes_t, nmask_t


# rows of the sweep table's upload that are held row-major on the device
# at once, before their transpose (128 MB of lanes at L 100)
UPLOAD_CHUNK_ROWS = 1 << 22


def sweep_lanes_to_device(lanes: np.ndarray, nmask: np.ndarray | None, device):
    """`packed.pack_lanes` output -> the overlap sweep's column-major table
    on `device`: int32 lanes [W+1, n] and N mask [Wn+1, n] or None
    (`packed.empty_cols`: lane c of every row contiguous). The rows are
    uploaded as they lie, UPLOAD_CHUNK_ROWS at a time, and transposed on
    the device into the table, so no full row-major copy is held beside it
    and the host does no transpose."""
    out = []
    for a in (lanes, nmask):
        if a is None:
            out.append(None)
            continue
        t = packed.empty_cols(a.shape[1], a.shape[0], device)
        for lo in range(0, a.shape[0], UPLOAD_CHUNK_ROWS):
            rows = uint.np_u32_to_tensor(a[lo:lo + UPLOAD_CHUNK_ROWS], device)
            t[:, lo:lo + rows.shape[0]].copy_(rows.t())
            del rows
        out.append(t)
    return tuple(out)


def lanes_from_device(lanes_t: torch.Tensor, nmask_t: torch.Tensor | None):
    return (uint.tensor_to_np_u32(lanes_t),
            None if nmask_t is None else uint.tensor_to_np_u32(nmask_t))


def hashes_to_device(h: np.ndarray, device) -> torch.Tensor:
    """u64 rolling hashes (`h0`, `h0b`, ...) -> int64 bit patterns."""
    return uint.np_u64_to_tensor(h, device)


def hashes_from_device(h_t: torch.Tensor) -> np.ndarray:
    return uint.tensor_to_np_u64(h_t)


def pg_lanes_to_device(pg_codes: np.ndarray, device) -> torch.Tensor:
    """Packed pg text (16 symbols per u32, N packed as A, the layout of
    `pgrc_tpu.core.packed.pack_text_2bit`) plus ONE zero lane, so a verify
    window's `+1` lane never reads out of bounds (the reference pads with
    zeros the same way, matcher.py:535-536)."""
    lanes = np.zeros(-(-pg_codes.shape[0] // 16) + 1, np.uint32)
    pack_text_2bit(pg_codes, lanes[:-1])
    return uint.np_u32_to_tensor(lanes, device)


def pack_text_2bit(codes: np.ndarray, out: np.ndarray,
                   chunk_lanes: int = 1 << 22) -> None:
    """`pgrc_tpu.core.packed.pack_text_2bit` into `out` [ceil(n/16)] u32, in
    byte operations on chunks: four 2-bit codes make a byte, four bytes read
    big-endian make a lane. Peak memory stays two chunks, and a
    2G-symbol pg packs in seconds (the reference's u32 temporaries take
    about 9 bytes per symbol at once, ~21 GB at 2.3G symbols)."""
    for lo in range(0, out.shape[0], chunk_lanes):
        hi = min(lo + chunk_lanes, out.shape[0])
        seg = codes[lo * 16 : hi * 16]
        buf = np.zeros(((hi - lo), 4, 4), np.uint8)
        np.bitwise_and(seg, 3, out=buf.reshape(-1)[: seg.shape[0]])
        byte = (buf[:, :, 0] << 6) | (buf[:, :, 1] << 4) | (buf[:, :, 2] << 2) | buf[:, :, 3]
        out[lo:hi] = byte.view(">u4").reshape(hi - lo)


def index_to_device(ihash: np.ndarray, ipos: np.ndarray, device, wide: bool = False):
    """Sampled k-mer table (u32 hashes, positions with -1 = inert) ->
    (int32 hash bits, positions: int64 for the wide probe, else int32)."""
    if not wide and ipos.size and int(ipos.max()) >= (1 << 31):
        raise ValueError("index positions past 2^31 need the wide probe")
    return (uint.np_u32_to_tensor(ihash.astype(np.uint32), device),
            to_device(ipos.astype(np.int64 if wide else np.int32), device))


def index_from_device(ihash_t: torch.Tensor, ipos_t: torch.Tensor):
    return uint.tensor_to_np_u32(ihash_t), to_host(ipos_t).numpy()


def match_from_device(mis_t: torch.Tensor, pos_t: torch.Tensor):
    """Probe outputs (uint8 mismatches, 255 = none; int32 or int64
    positions, -1 = none) -> the reference's host dtypes (uint8, int64)."""
    return (to_host(mis_t).numpy().astype(np.uint8),
            to_host(pos_t).numpy().astype(np.int64))
