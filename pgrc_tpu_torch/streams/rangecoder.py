"""Adaptive byte-wise range coder (order-0 / order-1, optional period).

Fills the reference's rangecoder role (coders/RangeCoder.cpp + SIMPLE_MODEL):
adaptive frequency models with periodic context (a separate model per position
modulo `period`). This pure-Python implementation is the correctness
reference; the C++ extension (pgrc_tpu/native) provides the fast path and
stays bit-compatible with it.

Coder: Subbotin-style 32-bit carryless range coder with byte renormalization.
Model: per-context adaptive symbol frequencies, increment 32, halved (rounding
up) when the total exceeds 2^16.
"""
from __future__ import annotations

import numpy as np

TOP = 1 << 24
BOT = 1 << 16
MASK = 0xFFFFFFFF
INC = 32
MAX_TOTAL = 1 << 16


class _Model:
    __slots__ = ("freq", "total")

    def __init__(self, nsym: int):
        self.freq = [1] * nsym
        self.total = nsym

    def cum(self, sym: int) -> tuple[int, int, int]:
        lo = sum(self.freq[:sym])
        return lo, self.freq[sym], self.total

    def find(self, scaled: int) -> tuple[int, int, int]:
        lo = 0
        for i, fi in enumerate(self.freq):
            if lo + fi > scaled:
                return i, lo, fi
            lo += fi
        raise AssertionError("range coder model desync")

    def update(self, sym: int) -> None:
        self.freq[sym] += INC
        self.total += INC
        if self.total > MAX_TOTAL:
            t = 0
            f = self.freq
            for i in range(len(f)):
                f[i] = (f[i] + 1) >> 1
                t += f[i]
            self.total = t


def _contexts(order: int, period: int, nsym: int):
    n_ctx = (nsym if order else 1) * period
    return [_Model(nsym) for _ in range(n_ctx)]


def _ctx_index(order: int, period: int, prev: int, pos: int) -> int:
    base = prev if order else 0
    return base * period + (pos % period)


def encode(data: np.ndarray, order: int = 0, period: int = 1, nsym: int = 256) -> bytes:
    data = np.asarray(data, dtype=np.uint8)
    from .. import native

    fast = native.rc_encode(data.tobytes(), order, period, nsym)
    if fast is not None:
        return fast
    return _py_encode(data, order, period, nsym)


def _py_encode(data: np.ndarray, order: int = 0, period: int = 1, nsym: int = 256) -> bytes:
    data = np.asarray(data, dtype=np.uint8)
    models = _contexts(order, period, nsym)
    out = bytearray()
    low = 0
    rng = MASK
    prev = 0
    for pos, sym in enumerate(data.tolist()):
        m = models[_ctx_index(order, period, prev, pos)]
        clo, f, tot = m.cum(sym)
        rng //= tot
        low = (low + clo * rng) & MASK
        rng *= f
        while True:
            if ((low ^ (low + rng)) & MASK) < TOP:
                pass
            elif rng < BOT:
                rng = BOT - (low & (BOT - 1))
            else:
                break
            out.append((low >> 24) & 0xFF)
            low = (low << 8) & MASK
            rng = (rng << 8)
            if rng > MASK:
                rng = MASK
        m.update(sym)
        prev = sym
    for _ in range(4):
        out.append((low >> 24) & 0xFF)
        low = (low << 8) & MASK
    return bytes(out)


def _ctx_count(nsym: int, order: int) -> int:
    cap = min(1 << 22, max((1 << 24) // nsym, 1))
    n = 1
    for _ in range(order):
        n *= nsym
        if n >= cap:
            return cap
    return n


def encode_ctx(data: np.ndarray, nsym: int, order: int) -> bytes:
    """Order-`order` context-model range coding (the PPMd role): the context
    is the last `order` symbols, ctx' = (ctx*nsym + sym) mod nsym^order."""
    data = np.asarray(data, dtype=np.uint8)
    from .. import native

    fast = native.rcx_encode(data.tobytes(), nsym, order)
    if fast is not None:
        return fast
    return _py_encode_ctx(data, nsym, order)


def decode_ctx(data: bytes, count: int, nsym: int, order: int) -> np.ndarray:
    from .. import native

    fast = native.rcx_decode(bytes(data), count, nsym, order)
    if fast is not None:
        return np.frombuffer(fast, dtype=np.uint8)
    return _py_decode_ctx(data, count, nsym, order)


def _py_encode_ctx(data: np.ndarray, nsym: int, order: int) -> bytes:
    n_ctx = _ctx_count(nsym, order)
    models = [_Model(nsym) for _ in range(n_ctx)]
    out = bytearray()
    low = 0
    rng = MASK
    ctx = 0
    for sym in np.asarray(data, dtype=np.uint8).tolist():
        m = models[ctx]
        clo, f, tot = m.cum(sym)
        rng //= tot
        low = (low + clo * rng) & MASK
        rng *= f
        while True:
            if ((low ^ (low + rng)) & MASK) < TOP:
                pass
            elif rng < BOT:
                rng = BOT - (low & (BOT - 1))
            else:
                break
            out.append((low >> 24) & 0xFF)
            low = (low << 8) & MASK
            rng = rng << 8
            if rng > MASK:
                rng = MASK
        m.update(sym)
        ctx = (ctx * nsym + sym) % n_ctx
    for _ in range(4):
        out.append((low >> 24) & 0xFF)
        low = (low << 8) & MASK
    return bytes(out)


def _py_decode_ctx(data: bytes, count: int, nsym: int, order: int) -> np.ndarray:
    n_ctx = _ctx_count(nsym, order)
    models = [_Model(nsym) for _ in range(n_ctx)]
    out = np.zeros(count, dtype=np.uint8)
    buf = data + b"\x00" * 8
    pos_in = 4
    code = int.from_bytes(buf[:4], "big")
    low = 0
    rng = MASK
    ctx = 0
    for pos in range(count):
        m = models[ctx]
        tot = m.total
        rng //= tot
        scaled = ((code - low) & MASK) // rng
        if scaled >= tot:
            scaled = tot - 1
        sym, clo, f = m.find(scaled)
        low = (low + clo * rng) & MASK
        rng *= f
        while True:
            if ((low ^ (low + rng)) & MASK) < TOP:
                pass
            elif rng < BOT:
                rng = BOT - (low & (BOT - 1))
            else:
                break
            code = ((code << 8) | buf[pos_in]) & MASK
            pos_in += 1
            low = (low << 8) & MASK
            rng = rng << 8
            if rng > MASK:
                rng = MASK
        m.update(sym)
        out[pos] = sym
        ctx = (ctx * nsym + sym) % n_ctx
    return out


def decode(data: bytes, count: int, order: int = 0, period: int = 1, nsym: int = 256) -> np.ndarray:
    from .. import native

    fast = native.rc_decode(bytes(data), count, order, period, nsym)
    if fast is not None:
        return np.frombuffer(fast, dtype=np.uint8)
    return _py_decode(data, count, order, period, nsym)


def _py_decode(data: bytes, count: int, order: int = 0, period: int = 1, nsym: int = 256) -> np.ndarray:
    models = _contexts(order, period, nsym)
    out = np.zeros(count, dtype=np.uint8)
    buf = data + b"\x00" * 8
    pos_in = 4
    code = int.from_bytes(buf[:4], "big")
    low = 0
    rng = MASK
    prev = 0
    for pos in range(count):
        m = models[_ctx_index(order, period, prev, pos)]
        tot = m.total
        rng //= tot
        scaled = ((code - low) & MASK) // rng
        if scaled >= tot:
            scaled = tot - 1
        sym, clo, f = m.find(scaled)
        low = (low + clo * rng) & MASK
        rng *= f
        while True:
            if ((low ^ (low + rng)) & MASK) < TOP:
                pass
            elif rng < BOT:
                rng = BOT - (low & (BOT - 1))
            else:
                break
            code = ((code << 8) | buf[pos_in]) & MASK
            pos_in += 1
            low = (low << 8) & MASK
            rng = (rng << 8)
            if rng > MASK:
                rng = MASK
        m.update(sym)
        out[pos] = sym
        prev = sym
    return out
