"""The benchmark of `pgrc_tpu_torch`, the PgRC compressor on PyTorch and CUDA.

`run.py` runs one cell on one card; BENCHMARK.json at the checkout's root
lists the cells, the configurations (`configs/`), the traffic mixes
(`traffic/`) and the metrics (`metrics/`, a reader each). It imports neither
JAX nor `pgrc_tpu`; its reference (`reference.py`, `pgtc_decoder/`) imports
nothing of `pgrc_tpu_torch` either.
"""
