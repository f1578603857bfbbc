"""Kernels G, `sweep_full_hashes`, and G2, `sweep_init_links`: the sweep's
init (csrc/sweep_init.cu). G replaces greedy_scs.py `_build_init_fn`'s and
`_build_hash_fn`'s Horner loops (:429-441, :475-483) and writes the init's
sort key; G2 replaces the init's linking (:442-465) after the stable sort:
a fill kernel writes every row's unlinked state (:457-465), and G2 proper
writes the links of equal neighbours over it, touching only tied
positions.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import state
from ..core.packed import col_vals
from ..overlap.host import HASH_BASE64, HASH_BASE64B
from ..utils.uint import SIGN64, s64
from . import check, check_cols, launch, launches, on_cpu, ptr

_A, _B = int(HASH_BASE64), int(HASH_BASE64B)
_U64 = (1 << 64) - 1
_tables: dict = {}


def chunk_tables(base: int):
    """Kernel G's chunked Horner tables for one hash base X, mod 2^64: T[byte]
    = sum_i code_i X^(3-i), code_i the byte's bits 7-2i..6-2i (its four
    symbols, the first in the top bits), and TN[nib] = sum_i 4 bit_i
    X^(3-i), bit_i the nibble's bit 3-i (the four symbols' N bits). Per byte
    of lane bits, h * X^4 + T[byte] + TN[nib] is four steps of h * X + v.
    -> (T, TN): 256 and 16 Python ints."""
    powers = [pow(base, 3 - i, 1 << 64) for i in range(4)]
    t = [sum(((b >> (6 - 2 * i)) & 3) * powers[i] for i in range(4)) & _U64 for b in range(256)]
    tn = [sum(4 * ((b >> (3 - i)) & 1) * powers[i] for i in range(4)) & _U64 for b in range(16)]
    return t, tn


def table_tensor(device) -> torch.Tensor:
    """G's tables as the kernel reads them, int64 [272, 2]: rows 0-255 the
    byte table, rows 256-271 the N-nibble table, column 0 for HASH_BASE64
    and 1 for HASH_BASE64B (u64 bit patterns). Built once per device."""
    device = torch.device(device)
    if device not in _tables:
        (ta, tna), (tb, tnb) = chunk_tables(_A), chunk_tables(_B)
        _tables[device] = state.to_device(
            np.array([[s64(a), s64(b)] for a, b in zip(ta + tna, tb + tnb)], dtype=np.int64),
            device)
    return _tables[device]


def sweep_full_hashes_plain(lanes, nmask, L: int, with_key: bool = False):
    """Both full-read u64 hashes by Horner over the columns of a
    column-major table; with_key adds the init's order key min(h0, INV64 -
    1) ^ SIGN64."""
    n = lanes.shape[1]
    h = torch.zeros((n,), dtype=torch.int64, device=lanes.device)
    hb = torch.zeros_like(h)
    for t in range(L):
        v = col_vals(lanes, nmask, t)
        h = h * s64(_A) + v
        hb = hb * s64(_B) + v
    if not with_key:
        return h, hb
    return h, hb, torch.where(h == -1, -2, h) ^ SIGN64


def sweep_full_hashes(lanes: torch.Tensor, nmask: torch.Tensor | None, L: int,
                      with_key: bool = False):
    """lanes [W+1, n] int32 and nmask [Wn+1, n] int32 or None, the sweep
    table's column-major lanes (`kernels.check_cols`) -> (h0, h0b) [n]
    int64 (u64 bit patterns), and with_key the init's order key [n] int64.
    CUDA tensors run kernel G."""
    n = lanes.shape[1]
    check_cols(lanes, "lanes", n)
    if nmask is not None:
        check_cols(nmask, "nmask", n)
    if not 1 <= L <= 16 * lanes.shape[0] or (nmask is not None and L > 32 * nmask.shape[0]):
        raise ValueError(f"read length {L} out of range for {lanes.shape[0]} lanes")
    if on_cpu(lanes, nmask):
        return sweep_full_hashes_plain(lanes, nmask, L, with_key)
    dev = lanes.device
    h0 = torch.empty((n,), dtype=torch.int64, device=dev)
    h0b = torch.empty_like(h0)
    key = torch.empty_like(h0) if with_key else None
    launch("pgrc_sweep_full_hashes", dev, n, ptr(lanes), lanes.stride(0), ptr(nmask),
           0 if nmask is None else nmask.stride(0), L, _A, _B, ptr(table_tensor(dev)), ptr(h0),
           ptr(h0b), ptr(key))
    launches["sweep_full_hashes"] += 1
    return (h0, h0b, key) if with_key else (h0, h0b)


def link_defaults_plain(n: int, device, ovl=None):
    """The init's unlinked state of n rows: (succ -1, ovl 0 [n] int32,
    active_s, active_p true [n] bool); ovl written into the given [n] int32
    tensor, where one is given."""
    return (torch.full((n,), -1, dtype=torch.int32, device=device),
            torch.zeros((n,), dtype=torch.int32, device=device) if ovl is None else ovl.zero_(),
            torch.ones((n,), dtype=torch.bool, device=device),
            torch.ones((n,), dtype=torch.bool, device=device))


def link_defaults(n: int, device, ovl=None):
    """`link_defaults_plain`; on a CUDA device written in row order by G2's
    fill kernel (one launch, not four). G2 then patches it. `ovl`, an [n]
    int32 tensor or None, takes the overlaps: the sweep hands in the head of
    a buffer whose tail holds kernel J's counts."""
    device = torch.device(device)
    if ovl is not None:
        check(ovl, "ovl", torch.int32, (n,))
    if device.type == "cpu":
        return link_defaults_plain(n, device, ovl)
    outs = (torch.empty((n,), dtype=torch.int32, device=device),
            torch.empty((n,), dtype=torch.int32, device=device) if ovl is None else ovl,
            torch.empty((n,), dtype=torch.bool, device=device),
            torch.empty((n,), dtype=torch.bool, device=device))
    launch("pgrc_sweep_link_defaults", device, n, *(ptr(t) for t in outs))
    launches["sweep_link_defaults"] += 1
    return outs


def sweep_init_links_plain(ks, sidx, h0b, L: int, state):
    """Sorted position j links row sidx[j] to row sidx[j+1] when their keys
    and second hashes agree; the last position never links forward. The
    links are written, in place, over `state` (succ, ovl, active_s,
    active_p): the rows' unlinked state, `link_defaults_plain`'s. -> state"""
    succ, ovl, a_s, a_p = state
    hb_s = h0b[sidx]
    same = (ks[1:] == ks[:-1]) & (hb_s[1:] == hb_s[:-1])
    me, nx = sidx[:-1][same], sidx[1:][same]
    succ[me] = nx.to(torch.int32)
    ovl[me] = L
    a_s[me] = False
    a_p[nx] = False
    return state


def sweep_init_links(ks: torch.Tensor, sidx: torch.Tensor, h0b: torch.Tensor, L: int,
                     state: tuple):
    """ks [n] int64 stably sorted init keys, sidx [n] int64 their rows, h0b
    [n] int64 the second hashes by row, state (succ, ovl [n] int32,
    active_s, active_p [n] bool) the rows' unlinked state (`link_defaults`)
    -> state, with the links of equal neighbours written over it in place.
    CUDA tensors run kernel G2, which touches only tied positions."""
    n = ks.numel()
    check(ks, "ks", torch.int64, (n,))
    check(sidx, "sidx", torch.int64, (n,))
    check(h0b, "h0b", torch.int64, (n,))
    for t, name, dtype in zip(state, ("succ", "ovl", "active_s", "active_p"),
                              (torch.int32, torch.int32, torch.bool, torch.bool)):
        check(t, name, dtype, (n,))
    if on_cpu(ks, sidx, h0b, *state):
        return sweep_init_links_plain(ks, sidx, h0b, L, state)
    launch("pgrc_sweep_init_links", ks.device, n, ptr(ks), ptr(sidx), ptr(h0b), L,
           *(ptr(t) for t in state))
    launches["sweep_init_links"] += 1
    return state
