"""stage_s.pair_order: the seconds per encode of stage 6's pair-order
coding in PE and MIN_PE (span `order.pair_order` under `order.order_info`:
the pairs' list offsets and their streams), the mean over the traced
window's encodes, from the program's recorder (`pgrc_bench/spans.py`).
A program without that span reads None."""
from pgrc_bench import spans

SPAN = "order.pair_order"


def read(record):
    encodes = spans.window_encodes(record)
    if not encodes or not all(any(s["name"] == SPAN for s in e["spans"]) for e in encodes):
        return None
    return sum(spans.span_seconds(e, SPAN) for e in encodes) / len(encodes)
