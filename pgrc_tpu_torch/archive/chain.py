"""The stage-checkpoint schema (the chain-state persistence role).

The reference threads a shared chain-data object through its 7 stages
(pgrc/pgrc-data.h:11-42: divided reads sets, the three pseudogenomes, order
vectors); our encoder passes the equivalent arrays as stage-local values and
this module owns their persisted form for -B/-E stage bisection (reference
pgrc-params.h:299-317). CHECKPOINT_SCHEMA formalizes exactly which arrays
each stage checkpoint carries; save/load validate against it so a stale or
mismatched checkpoint fails loudly instead of KeyError-ing mid-chain.
"""
from __future__ import annotations

import numpy as np

CKPT_VERSION = 1

# stage -> required array keys in that stage's checkpoint file
CHECKPOINT_SCHEMA: dict[int, tuple[str, ...]] = {
    1: ("hq_idx", "lq_idx", "n_idx"),
    2: ("hq_idx", "lq_idx", "n_idx"),
    3: ("hq_idx", "lq_idx", "n_idx", "hq_pg", "hq_org", "hq_pos"),
    4: ("lq_un", "n_un", "matched_count", "e_pos", "e_org", "e_rc",
        "e_mis_cnt", "e_mis_sym", "e_mis_off", "hq_pg"),
    5: ("matched_count", "e_pos", "e_org", "e_rc",
        "e_mis_cnt", "e_mis_sym", "e_mis_off", "hq_pg",
        "lq_pg", "lq_org", "lq_pos", "n_pg", "n_org", "n_pos"),
}


def ckpt_path(params, stage: int) -> str:
    import os

    d = params.tmp_work_dir or (params.output + ".work")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"stage{stage}.npz")


def save_ckpt(params, stage: int, **arrays) -> None:
    missing = [k for k in CHECKPOINT_SCHEMA.get(stage, ()) if k not in arrays]
    if missing:
        raise ValueError(f"stage {stage} checkpoint missing keys: {missing}")
    np.savez_compressed(ckpt_path(params, stage),
                        __ckpt_version=np.int64(CKPT_VERSION),
                        __stage=np.int64(stage), **arrays)


def load_ckpt(params, stage: int) -> dict:
    path = ckpt_path(params, stage)
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    ver = int(d.pop("__ckpt_version", 0))
    got_stage = int(d.pop("__stage", stage))
    if ver != CKPT_VERSION:
        raise ValueError(
            f"{path}: checkpoint version {ver} != {CKPT_VERSION}")
    if got_stage != stage:
        raise ValueError(f"{path}: checkpoint is for stage {got_stage}, "
                         f"expected {stage}")
    missing = [k for k in CHECKPOINT_SCHEMA.get(stage, ()) if k not in d]
    if missing:
        raise ValueError(f"{path}: stage {stage} checkpoint missing {missing}")
    return d
