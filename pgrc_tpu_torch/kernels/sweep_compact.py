"""Kernel H, `sweep_compact`: the sweep table's compaction at a segment end
(csrc/sweep_compact.cu). Replaces greedy_scs.py `_build_compact_fn` (:488-528)
and the segment end's count readback (:391-397, :816-823).
"""
from __future__ import annotations

import torch

from ..core.packed import empty_cols
from . import TOTALS_WORD, build, check, check_cols, launch, launches, on_cpu, ptr


def tile() -> int:
    """Rows a tile of kernel H (csrc/sweep_compact.cu; half that for rows
    too wide for a block's shared memory), through the kernel library."""
    return build.lib().pgrc_sweep_compact_tile()


def _outputs(ins):
    """Uninitialised outputs of H: the lane and N-mask columns in fresh
    column-major storage (`empty_cols`), the rest like their inputs."""
    return tuple(None if v is None else empty_cols(*v.shape, v.device) if v.dim() == 2
                 else torch.empty_like(v) for v in ins)


def sweep_compact_plain(lanes, nmask, ids, h, p, h2, p2, a_s, a_p):
    """The rows with a_s | a_p, in row order, at the front of arrays of the
    inputs' shapes (the first k entries of each lane and N-mask column);
    the counts (kept rows, active suffixes, active prefixes)."""
    keep = torch.nonzero(a_s | a_p).squeeze(1)
    k = keep.numel()
    ins = (lanes, nmask, ids, h, p, h2, p2, a_s, a_p)
    out = _outputs(ins)
    for v, o in zip(ins, out):
        if v is not None:
            o[..., :k] = v[..., keep]
    counts = torch.tensor([k, int(a_s.sum()), int(a_p.sum())], dtype=torch.int64,
                          device=ids.device)
    return out, counts


def sweep_compact(lanes: torch.Tensor, nmask: torch.Tensor | None, ids: torch.Tensor,
                  h: torch.Tensor, p: torch.Tensor, h2: torch.Tensor, p2: torch.Tensor,
                  a_s: torch.Tensor, a_p: torch.Tensor):
    """A sweep table of n rows (lanes [W+1, n] int32 and nmask [Wn+1, n]
    int32 or None column-major, `kernels.check_cols`; ids [n] int32,
    h/p/h2/p2 [n] int64, a_s/a_p [n] bool) -> (the nine arrays again, of
    the same shapes, the lanes and N mask in fresh column-major storage,
    with the k rows that keep a_s | a_p first in row order and the rest
    undefined; counts [3] int64 on the tensors' device: k, the active
    suffixes, the active prefixes). CUDA tensors run kernel H."""
    n = ids.numel()
    check_cols(lanes, "lanes", n)
    if nmask is not None:
        check_cols(nmask, "nmask", n)
    check(ids, "ids", torch.int32, (n,))
    for name, t in (("h", h), ("p", p), ("h2", h2), ("p2", p2)):
        check(t, name, torch.int64, (n,))
    for name, t in (("a_s", a_s), ("a_p", a_p)):
        check(t, name, torch.bool, (n,))
    if on_cpu(lanes, nmask, ids, h, p, h2, p2, a_s, a_p):
        return sweep_compact_plain(lanes, nmask, ids, h, p, h2, p2, a_s, a_p)
    dev = ids.device
    ins = (lanes, nmask, ids, h, p, h2, p2, a_s, a_p)
    outs = _outputs(ins)
    scratch = torch.empty((build.lib().pgrc_sweep_compact_scratch_words(n),),
                          dtype=torch.int64, device=dev)
    # a column-major table's columns and column stride
    cols = lambda t: (0, 0) if t is None else (t.shape[0], t.stride(0))
    launch("pgrc_sweep_compact", dev, n, ptr(lanes), *cols(lanes), ptr(nmask), *cols(nmask),
           *(ptr(v) for v in ins[2:]), ptr(outs[0]), cols(outs[0])[1], ptr(outs[1]),
           cols(outs[1])[1], *(ptr(v) for v in outs[2:]), ptr(scratch), scratch.numel())
    launches["sweep_compact"] += 1
    return outs, scratch[TOTALS_WORD:TOTALS_WORD + 3]
