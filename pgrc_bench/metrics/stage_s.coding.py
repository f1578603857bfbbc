"""stage_s.coding: the host coding layer's seconds per encode (stages 6-7,
`order` and `pgseq`: the order and pseudogenome streams), the mean over the
traced window's encodes, from the encoder's own `stage_times`."""

STAGES = ('order', 'pgseq')


def read(record):
    encodes = record["encodes"]
    if not encodes or any(s not in e["stage_times"] for e in encodes for s in STAGES):
        return None
    return sum(e["stage_times"][s] for e in encodes for s in STAGES) / len(encodes)
