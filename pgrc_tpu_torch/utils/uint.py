"""Unsigned integers carried in signed torch tensors.

torch's uint32/uint64 lack `-`, `>>`, `<`, `maximum` and `cummax`, so the
port carries the reference's unsigned values in signed tensors of the same
bit pattern:

  * u32 values live in int32 (bit pattern) or in int64 (value 0..2^32-1);
  * u64 values live in int64 (bit pattern); `+ - *` wrap mod 2^64 exactly
    as unsigned arithmetic does;
  * where unsigned ORDER matters (sort keys, cummax), `order_key64` flips
    bit 63 so that signed order equals unsigned order;
  * `>>` on a signed tensor sign-extends, so every logical right shift goes
    through `lshr32` / `lshr64`, which mask after the shift.
"""
from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF
SIGN64 = -(1 << 63)            # int64 with only bit 63 set


def s64(c: int) -> int:
    """A u64 constant (Python int in [0, 2^64)) as the int64 of the same bits."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >> 63 else c


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor of the same bits (exact
    arithmetic, no reliance on narrowing-conversion behaviour)."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 tensor holding the u32 value."""
    return x.to(torch.int64) & U32_MASK


def lshr32(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a u32 carried in int32 or int64 (0 <= s < 32)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def lshr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of a u64 carried in int64 (0 < s < 64)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def order_key64(x: torch.Tensor) -> torch.Tensor:
    """u64 bit pattern -> int64 whose signed order is the unsigned order."""
    return x ^ SIGN64


def from_order_key64(k: torch.Tensor) -> torch.Tensor:
    """Inverse of `order_key64`."""
    return k ^ SIGN64


# numpy <-> carrier views (bit-exact, no copies beyond the device transfer)

def _expect(dtype_ok: bool, got) -> None:
    if not dtype_ok:
        raise TypeError(f"unexpected dtype {got}")


def np_u32_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    _expect(a.dtype == np.uint32, a.dtype)
    return torch.from_numpy(np.require(a, requirements="CW").view(np.int32)).to(device)


def tensor_to_np_u32(t: torch.Tensor) -> np.ndarray:
    _expect(t.dtype == torch.int32, t.dtype)
    return t.cpu().numpy().view(np.uint32)


def np_u64_to_tensor(a: np.ndarray, device) -> torch.Tensor:
    _expect(a.dtype == np.uint64, a.dtype)
    return torch.from_numpy(np.require(a, requirements="CW").view(np.int64)).to(device)


def tensor_to_np_u64(t: torch.Tensor) -> np.ndarray:
    _expect(t.dtype == torch.int64, t.dtype)
    return t.cpu().numpy().view(np.uint64)
