"""Kernel H, `sweep_compact`: the sweep table's compaction at a segment end
(csrc/sweep_compact.cu). Replaces greedy_scs.py `_build_compact_fn` (:488-528)
and the segment end's count readback (:391-397, :816-823).
"""
from __future__ import annotations

import torch

from . import TOTALS_WORD, build, check, launch, launches, on_cpu, ptr


def tile() -> int:
    """Rows a tile of kernel H (csrc/sweep_compact.cu; half that for rows
    too wide for a block's shared memory), through the kernel library."""
    return build.lib().pgrc_sweep_compact_tile()


def sweep_compact_plain(lanes, nmask, ids, h, p, h2, p2, a_s, a_p):
    """The rows with a_s | a_p, in row order, at the front of arrays of the
    inputs' shapes; the counts (kept rows, active suffixes, active
    prefixes)."""
    keep = torch.nonzero(a_s | a_p).squeeze(1)
    k = keep.numel()
    out = []
    for v in (lanes, nmask, ids, h, p, h2, p2, a_s, a_p):
        if v is None:
            out.append(None)
            continue
        o = torch.empty_like(v)
        o[:k] = v[keep]
        out.append(o)
    counts = torch.tensor([k, int(a_s.sum()), int(a_p.sum())], dtype=torch.int64,
                          device=ids.device)
    return tuple(out), counts


def sweep_compact(lanes: torch.Tensor, nmask: torch.Tensor | None, ids: torch.Tensor,
                  h: torch.Tensor, p: torch.Tensor, h2: torch.Tensor, p2: torch.Tensor,
                  a_s: torch.Tensor, a_p: torch.Tensor):
    """A sweep table of n rows (lanes [n, W+1] int32, nmask [n, Wn+1] int32
    or None, ids [n] int32, h/p/h2/p2 [n] int64, a_s/a_p [n] bool) -> (the
    nine arrays again, of the same shapes, with the k rows that keep a_s |
    a_p in their first k rows in row order and the rest undefined; counts
    [3] int64 on the tensors' device: k, the active suffixes, the active
    prefixes). CUDA tensors run kernel H."""
    n = ids.numel()
    check(lanes, "lanes", torch.int32, (n, None))
    if nmask is not None:
        check(nmask, "nmask", torch.int32, (n, None))
    check(ids, "ids", torch.int32, (n,))
    for name, t in (("h", h), ("p", p), ("h2", h2), ("p2", p2)):
        check(t, name, torch.int64, (n,))
    for name, t in (("a_s", a_s), ("a_p", a_p)):
        check(t, name, torch.bool, (n,))
    if on_cpu(lanes, nmask, ids, h, p, h2, p2, a_s, a_p):
        return sweep_compact_plain(lanes, nmask, ids, h, p, h2, p2, a_s, a_p)
    dev = ids.device
    ins = (lanes, nmask, ids, h, p, h2, p2, a_s, a_p)
    outs = tuple(None if v is None else torch.empty_like(v) for v in ins)
    scratch = torch.empty((build.lib().pgrc_sweep_compact_scratch_words(n),),
                          dtype=torch.int64, device=dev)
    launch("pgrc_sweep_compact", dev, n, ptr(lanes), lanes.shape[1], ptr(nmask),
           0 if nmask is None else nmask.shape[1], *(ptr(v) for v in ins[2:]),
           *(ptr(v) for v in outs), ptr(scratch), scratch.numel())
    launches["sweep_compact"] += 1
    return outs, scratch[TOTALS_WORD:TOTALS_WORD + 3]
