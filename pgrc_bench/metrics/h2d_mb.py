"""h2d_mb: host-to-card bytes per encode in MB (2^20 bytes; the program's
counter `h2d_bytes`: every upload crosses `state.to_device`), the mean over
the traced window's encodes, from the program's recorder
(`pgrc_bench/spans.py`)."""
from pgrc_bench import spans


def read(record):
    return spans.mean(record, lambda e: e["counters"].get("h2d_bytes", 0) / 2**20)
