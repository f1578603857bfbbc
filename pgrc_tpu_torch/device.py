"""Device selection: a name in, a `torch.device` out, and no silent fallback."""
from __future__ import annotations

import torch


def resolve(name: str | torch.device) -> torch.device:
    """`"cuda"`, `"cuda:N"` or `"cpu"` -> `torch.device`.

    Asking for CUDA where there is none raises: the port never moves work to
    the CPU on its own (the CPU runs the kernels' plain versions, which is a
    different program, not a slower copy of the same one)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (expected cuda or cpu)")
    return dev
