"""The port's graft entry (`__graft_entry_torch__.py`) against the
reference's (`__graft_entry__.py`): the same example data through the
port's probe on the CPU (kernels C, E and A by their plain versions) and
the reference's jitted probe give the same (mis, pos)."""
import numpy as np
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
