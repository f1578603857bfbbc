"""stage_s.pgdiv: the sweep layer's seconds per encode (stages 2+3, `pgdiv`:
the overlap sweep's division and the HQ pseudogenome), the mean over the
traced window's encodes, from the encoder's own `stage_times`."""

STAGES = ('pgdiv',)


def read(record):
    encodes = record["encodes"]
    if not encodes or any(s not in e["stage_times"] for e in encodes for s in STAGES):
        return None
    return sum(e["stage_times"][s] for e in encodes for s in STAGES) / len(encodes)
