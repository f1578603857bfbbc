"""device_syncs: the card's reads by the host per encode (the program's
counter `device_syncs`: every read crosses `state.to_host` and waits for
the card; one a sweep round, one a compaction, the links and the matcher's
results), the mean over the traced window's encodes, from the program's
recorder (`pgrc_bench/spans.py`)."""
from pgrc_bench import spans


def read(record):
    return spans.mean(record, lambda e: e["counters"].get("device_syncs", 0))
