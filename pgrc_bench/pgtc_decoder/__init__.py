"""A frozen, decode-only copy of the PGTC decoder of `pgrc_tpu_torch`.

The benchmark's reference judges each archive the timed encodes write by
decoding it with this copy and comparing the reads with the input it
generated. It is a copy so that no change to the program can move the
yardstick. It keeps only what `archive.decoder.load` and
`archive.decoder.decode_to_matrices` reach, the port's decoding code as it
stood: the archive and stream readers, the coders' decoders, the pair-order
walk and the reads' reconstruction; none of the port's encoding side. It
imports neither torch nor the port: its native library (the range, context
and rANS decoders and the pair walk) is built by g++ beside its own sources,
and the reference runs only where it builds.
"""

ARCHIVE_MAGIC = b"PGTC"
