"""setup_s: the seconds from the run's start to the warm-up encode's end: the
input's generation, the imports, the CUDA context, the port's kernel and
native libraries (built when absent) and one encode of the cell's input."""


def read(record):
    return record["setup_s"]
