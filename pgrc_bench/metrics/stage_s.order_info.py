"""stage_s.order_info: the seconds per encode of stage 6's order coding in
the order-preserving modes (span `order.order_info`: the `pos_by_org`
scatter `order.ord_positions`, then the position streams' codec probes and
compression `order.ord_streams`), the mean over the traced window's
encodes, from the program's recorder (`pgrc_bench/spans.py`). An encode
without `order.ord_streams` (another mode, or a program that does not mark
the ORD path) reads None."""
from pgrc_bench import spans

SPAN = "order.order_info"
MARK = "order.ord_streams"


def read(record):
    encodes = spans.window_encodes(record)
    if not encodes or not all(any(s["name"] == MARK for s in e["spans"]) for e in encodes):
        return None
    return sum(spans.span_seconds(e, SPAN) for e in encodes) / len(encodes)
