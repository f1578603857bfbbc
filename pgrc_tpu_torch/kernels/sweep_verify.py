"""Kernel J, `sweep_verify_links`: the exact check of a device sweep's links
on the card (csrc/sweep_verify.cu). Replaces, on the device path, the host
pass after the rounds, greedy_scs.py `_verify_links` (:866-888; the port's
copy in overlap/host.py, which the numpy sweep of small inputs keeps): each
link x -> succ[x] at overlap ovl[x] is compared, symbol for symbol, on the
sweep table it was found on, and cut where x's last ovl[x] symbols are not
succ[x]'s first. The links checked and cut are counted on the device.
"""
from __future__ import annotations

import torch

from ..core.packed import col_vals
from . import check, check_cols, launch, launches, on_cpu, ptr

# J's counts, in this order: links checked, links cut
COUNTS = 2
# links the plain version compares at once (bounds its [links, L] temporaries)
_PLAIN_CHUNK = 1 << 16


def sweep_verify_links_plain(lanes, nmask, L: int, succ, ovl, counts) -> None:
    """Cut, in place, every link x -> succ[x] whose overlap ovl[x] differs:
    row x's symbols L - o .. L - 1 against succ[x]'s 0 .. o - 1, each a
    symbol value of the column-major table (`col_vals`: 2-bit code + 4 * N
    bit). counts <- (links checked, links cut)."""
    # [n, L] uint8: symbol t of row r at vals[r, t]
    vals = torch.stack([col_vals(lanes, nmask, t).to(torch.uint8) for t in range(L)], dim=1)
    linked = torch.nonzero(succ >= 0).squeeze(1)
    cols = torch.arange(L, dtype=torch.int64, device=succ.device)
    cut = 0
    for lo in range(0, linked.numel(), _PLAIN_CHUNK):
        x = linked[lo:lo + _PLAIN_CHUNK]
        y = succ[x].to(torch.int64)
        o = ovl[x].to(torch.int64)[:, None]
        inside = cols[None, :] < o
        mine = vals[x[:, None], (L - o + cols[None, :]).clamp(max=L - 1)]
        bad = ((mine != vals[y]) & inside).any(dim=1)
        x = x[bad]
        succ[x] = -1
        ovl[x] = 0
        cut += x.numel()
    counts[0] = linked.numel()
    counts[1] = cut


def sweep_verify_links(lanes: torch.Tensor, nmask: torch.Tensor | None, L: int,
                       succ: torch.Tensor, ovl: torch.Tensor, counts: torch.Tensor) -> None:
    """lanes [W+1, n] int32 and nmask [Wn+1, n] int32 or None, the sweep
    table's column-major lanes as uploaded (`kernels.check_cols`; W =
    ceil(L/16), Wn = ceil(L/32), each with its pad word), succ and ovl [n]
    int32 the links found on it (succ -1 = none; ovl in [1, L] where linked),
    counts [COUNTS] int32 -> every link whose overlap differs cut in place
    (succ -1, ovl 0); counts = (links checked, links cut). CUDA tensors run
    kernel J."""
    n = succ.numel()
    check_cols(lanes, "lanes", n)
    if nmask is not None:
        check_cols(nmask, "nmask", n)
    if not 1 <= L or lanes.shape[0] < -(-L // 16) + 1 or (
            nmask is not None and nmask.shape[0] < -(-L // 32) + 1):
        raise ValueError(f"read length {L} out of range for {lanes.shape[0]} lanes "
                         f"with their pad")
    check(succ, "succ", torch.int32, (n,))
    check(ovl, "ovl", torch.int32, (n,))
    check(counts, "counts", torch.int32, (COUNTS,))
    if on_cpu(lanes, nmask, succ, ovl, counts):
        return sweep_verify_links_plain(lanes, nmask, L, succ, ovl, counts)
    launch("pgrc_sweep_verify_links", succ.device, n, ptr(lanes), lanes.stride(0), ptr(nmask),
           0 if nmask is None else nmask.stride(0), L, ptr(succ), ptr(ovl), ptr(counts))
    launches["sweep_verify_links"] += 1
