"""The port's multi-device layer: a 1-D group of ranks over torch.distributed
(`mesh.Mesh`), the counterpart of `pgrc_tpu/parallel/mesh.py`."""
