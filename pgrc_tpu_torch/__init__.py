"""pgrc_tpu_torch — the PgRC compressor on PyTorch and CUDA (NVIDIA Hopper).

A port of `pgrc_tpu` (the JAX reference, which stays beside it unchanged).
The port owns only what touches the device: the overlap sweep
(`overlap.greedy_scs`), the read matcher (`align.matcher`), the encoder
chain that calls them (`archive.encoder`) and the CLI (`cli`). Everything
device-neutral — FASTQ ingest, stream coders, the PGTC container, the
decoder, the native C++ helpers — is imported from `pgrc_tpu`, so both
packages write byte-identical archives from one implementation of the
format.

The compressor has no parameters, no gradients and no randomness, so the
port is plain functions on tensors with an explicit `device` argument: no
`nn.Module`, no `autograd.Function`, no generator. Hand-written CUDA
kernels (`kernels/`) carry the bit-arithmetic hot spots; each has a plain
PyTorch twin that runs on CPU tensors and in the tests.

This package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"
