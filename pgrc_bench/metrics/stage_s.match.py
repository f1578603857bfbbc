"""stage_s.match: the matcher layer's seconds per encode (stage 4, `match`: LQ
reads placed on the HQ pseudogenome), the mean over the traced window's
encodes, from the encoder's own `stage_times`."""

STAGES = ('match',)


def read(record):
    encodes = record["encodes"]
    if not encodes or any(s not in e["stage_times"] for e in encodes for s in STAGES):
        return None
    return sum(e["stage_times"][s] for e in encodes for s in STAGES) / len(encodes)
