"""The port's graft entry (`__graft_entry_torch__.py`) against the
reference's (`__graft_entry__.py`): the same example data through the
port's probe on the CPU (kernels C, E and A by their plain versions) and
the reference's jitted probe give the same (mis, pos); the dry runs of the
production encoder over a group of ranks (gloo on the CPU) hold every
rank's archive to the one-device archive, which is pgrc_tpu's."""
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
import __graft_entry_torch__ as port_entry


def test_entry_matches_reference_entry():
    fn, args = port_entry.entry(device="cpu")
    mis, pos = fn(*args)
    assert mis.dtype == torch.uint8 and pos.dtype == torch.int32
    assert tuple(mis.shape) == tuple(pos.shape) == (1024,)
    ref_fn, ref_args = ref_entry.entry()
    want_mis, want_pos = (np.asarray(o) for o in ref_fn(*ref_args))
    np.testing.assert_array_equal(mis.numpy(), want_mis)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    assert (want_mis != 255).mean() > 0.9


def test_entry_data_is_the_reference_entrys():
    """The copied generator makes the reference entry's reads, pg and index."""
    reads, pg, index, offs = port_entry._example_data()
    ref_reads, _, ref_offs, ref_index, _ = ref_entry._example_data()
    np.testing.assert_array_equal(reads, ref_reads)
    assert offs == tuple(ref_offs) and index.k == ref_index.k
    np.testing.assert_array_equal(index.hash_sorted, ref_index.hash_sorted)
    np.testing.assert_array_equal(index.pos_sorted, ref_index.pos_sorted)
    assert pg.size == ref_index.pg_len


def test_dryrun_multichip_on_cpu_ranks(capsys):
    """The twin of tests/test_graft_entry.py::test_dryrun_multichip_runs:
    the production encoder over 4 gloo CPU ranks, every rank's archive
    equal to the one-device archive, which round-trips."""
    port_entry.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK on 4 ranks (cpu)" in capsys.readouterr().out


def test_dryrun_input_and_archive_are_the_references(tmp_path):
    """The dry runs' input is the reference dry run's (the copied
    generator), and the port's one-device archive of it is pgrc_tpu's."""
    from pgrc_tpu.archive import encoder as ref_encoder
    from pgrc_tpu.config import PgRCParams

    ref_src, port_dir = str(tmp_path / "ref.fastq"), tmp_path / "port"
    port_dir.mkdir()
    ref_entry._write_tiny_fastq(ref_src, n_reads=768, read_len=48, seed=3)
    src, got = port_entry._one_device_archive(str(port_dir), "cpu")
    with open(src, "rb") as a, open(ref_src, "rb") as b:
        assert a.read() == b.read()
    out = str(tmp_path / "ref.pgtc")
    ref_encoder.encode(PgRCParams(src_fastq=ref_src, output=out))
    with open(out, "rb") as f:
        assert f.read() == got


@pytest.mark.slow
def test_dryrun_multihost_on_cpu_ranks():
    """The twin of tests/test_multihost.py: 2 processes x 4 gloo ranks of
    one group over TCP on localhost, every archive the one-device one."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(root, "__graft_entry_torch__.py"),
                        "dryrun_multihost", "cpu"], capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "dryrun_multihost OK" in r.stdout
