"""pgrc_tpu_torch — the PgRC compressor on PyTorch and CUDA (NVIDIA Hopper).

A port of `pgrc_tpu` (the JAX reference, which stays beside it unchanged).
The port stands on its own: it imports nothing of `pgrc_tpu`. Its device
layer is its own code: the overlap sweep (`overlap.greedy_scs`), the read
matcher (`align.matcher`), the encoder chain that calls them
(`archive.encoder`) and the CLI (`cli`). Its host layer — FASTQ ingest
(`core`), stream coders and the PGTC container (`streams`), the decoder and
the archive sections (`archive`), the native C++ helpers (`native`), the
parameters (`config`) and the sweep's and matcher's host pieces
(`overlap.host`, `align.host`) — is a copy of the reference's modules with
only their imports changed, so both packages write byte-identical archives
and the tests can hold one against the other.

The compressor has no parameters, no gradients and no randomness, so the
port is plain functions on tensors with an explicit `device` argument: no
`nn.Module`, no `autograd.Function`, no generator. Hand-written CUDA
kernels (`kernels/`) carry the device hot spots; each has a plain PyTorch
twin that runs on CPU tensors and in the tests.

This package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"

ARCHIVE_MAGIC = b"PGTC"
ARCHIVE_VERSION = (1, 0)

from .utils.errors import PgtcFormatError  # noqa: E402,F401  (public API)
