"""stage_s.ingest: the ingest layer's seconds per encode (stages `input` and
`div`: FASTQ parse and quality division), the mean over the traced window's
encodes, from the encoder's own `stage_times`."""

STAGES = ('input', 'div')


def read(record):
    encodes = record["encodes"]
    if not encodes or any(s not in e["stage_times"] for e in encodes for s in STAGES):
        return None
    return sum(e["stage_times"][s] for e in encodes for s in STAGES) / len(encodes)
