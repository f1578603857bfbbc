"""pair_offsets_full_share: the share of pairs whose mates lie more than
255 places apart in the pg-ordered reads list, so that stage 6 codes their
offset in the u32 fallback stream rather than in one byte (the program's
counters `pair.offsets_full` / `pair.pairs`), over the traced window's
encodes, from the program's recorder (`pgrc_bench/spans.py`). A program
without those counters reads None."""
from pgrc_bench import spans


def read(record):
    encodes = spans.window_encodes(record)
    if not encodes or not all("pair.pairs" in e["counters"] for e in encodes):
        return None
    pairs = sum(e["counters"]["pair.pairs"] for e in encodes)
    full = sum(e["counters"].get("pair.offsets_full", 0) for e in encodes)
    return full / pairs if pairs else None
