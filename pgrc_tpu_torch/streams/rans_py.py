"""Pure-Python mirror of native/rans.cpp (static order-0 rANS, FSE role).

Bit-compatible with the native coder: same normalization, same stream
layout, same renormalization. It encodes where the native coder's output
buffer overflows (`codecs.rans_compress`), and is the tests' reference for
the native coder."""
from __future__ import annotations

SCALE_BITS = 12
SCALE = 1 << SCALE_BITS
RANS_L = 1 << 23


def _normalize(counts, total):
    freq = [0] * 256
    assigned = 0
    maxi = 0
    for s in range(256):
        if not counts[s]:
            continue
        f = counts[s] * SCALE // total
        if f == 0:
            f = 1
        freq[s] = f
        assigned += f
        if counts[s] > counts[maxi]:
            maxi = s
    drift = SCALE - assigned
    nf = freq[maxi] + drift
    if nf < 1:
        freq[maxi] = 1
        drift = nf - 1
        for s in range(256):
            if not drift:
                break
            if s == maxi or freq[s] <= 1:
                continue
            take = min(freq[s] - 1, -drift)
            freq[s] -= take
            drift += take
    else:
        freq[maxi] = nf
    return freq


def encode(data: bytes) -> bytes:
    n = len(data)
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    freq = _normalize(counts, n) if n else [0] * 256
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freq[s]
    n_syms = sum(1 for f in freq if f)
    out = bytearray()
    out += n_syms.to_bytes(2, "little")
    for s in range(256):
        if freq[s]:
            out.append(s)
            out += freq[s].to_bytes(2, "little")
    scratch = bytearray()
    state = RANS_L
    for i in range(n - 1, -1, -1):
        f = freq[data[i]]
        x_max = ((RANS_L >> SCALE_BITS) << 8) * f
        while state >= x_max:
            scratch.append(state & 0xFF)
            state >>= 8
        state = ((state // f) << SCALE_BITS) + (state % f) + cum[data[i]]
    out += state.to_bytes(4, "little")
    out += bytes(reversed(scratch))
    return bytes(out)


def decode(buf: bytes, count: int) -> bytes:
    if len(buf) < 2:
        if count == 0:
            return b""
        raise ValueError("malformed rANS stream")
    n_syms = int.from_bytes(buf[0:2], "little")
    if n_syms > 256 or 2 + 3 * n_syms + 4 > len(buf):
        raise ValueError("malformed rANS stream")
    freq = [0] * 256
    p = 2
    for _ in range(n_syms):
        s = buf[p]
        freq[s] = int.from_bytes(buf[p + 1 : p + 3], "little")
        p += 3
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freq[s]
    if count > 0 and cum[256] != SCALE:
        raise ValueError("malformed rANS stream")
    slot2sym = bytearray(SCALE)
    for s in range(256):
        for j in range(cum[s], cum[s + 1]):
            slot2sym[j] = s
    state = int.from_bytes(buf[p : p + 4], "little")
    p += 4
    out = bytearray(count)
    mask = SCALE - 1
    for i in range(count):
        slot = state & mask
        sym = slot2sym[slot]
        out[i] = sym
        state = freq[sym] * (state >> SCALE_BITS) + slot - cum[sym]
        while state < RANS_L:
            if p >= len(buf):
                raise ValueError("malformed rANS stream")
            state = (state << 8) | buf[p]
            p += 1
    return bytes(out)
