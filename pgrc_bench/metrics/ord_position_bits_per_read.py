"""ord_position_bits_per_read: the compressed bits of the order-preserving
modes' position streams per read whose position they store (the program's
counters `ord.position_bytes` x 8 / `ord.reads`), over the traced window's
encodes, from the program's recorder (`pgrc_bench/spans.py`). A program
without those counters reads None."""
from pgrc_bench import spans


def read(record):
    encodes = spans.window_encodes(record)
    if not encodes or not all("ord.reads" in e["counters"] for e in encodes):
        return None
    reads = sum(e["counters"]["ord.reads"] for e in encodes)
    stored = sum(e["counters"].get("ord.position_bytes", 0) for e in encodes)
    return stored * 8 / reads if reads else None
