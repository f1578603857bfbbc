"""The whole slice: SE compress through the port's CLI on the CPU writes the
reference's archive byte for byte, and it decodes to the input."""
import os

import pytest

from pgrc_tpu import cli as ref_cli
from pgrc_tpu.archive import decoder
from pgrc_tpu.overlap import greedy_scs as ref_scs
from pgrc_tpu_torch import cli as port_cli
from pgrc_tpu_torch.overlap import greedy_scs as port_scs
from test_roundtrip import read_lines_file, synth_fastq


@pytest.fixture(scope="module")
def se_archives(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("slice"))
    src = os.path.join(d, "in.fastq")
    codes = synth_fastq(src, 3000, 100, 9000, seed=31)
    mp = pytest.MonkeyPatch()
    try:
        # both sweeps past their numpy mirror: the device paths are compared
        mp.setattr(ref_scs, "_HOST_SWEEP_MAX", 0)
        mp.setattr(port_scs, "_HOST_SWEEP_MAX", 0)
        assert ref_cli.main(["-i", src, os.path.join(d, "ref.pgtc")]) == 0
        assert port_cli.main(["--device", "cpu", "-i", src,
                              os.path.join(d, "port.pgtc")]) == 0
    finally:
        mp.undo()
    return d, codes


def test_archive_bytes_equal_reference(se_archives):
    d, codes = se_archives
    with open(os.path.join(d, "ref.pgtc"), "rb") as f:
        want = f.read()
    with open(os.path.join(d, "port.pgtc"), "rb") as f:
        got = f.read()
    assert got == want
    assert (codes == 4).any(axis=1).sum() > 20        # N reads took part
    assert len(got) * 8 / codes.size < 0.5


def test_port_archive_decodes_to_input(se_archives):
    d, codes = se_archives
    n = decoder.decode_to_files(os.path.join(d, "port.pgtc"), os.path.join(d, "dec"))
    assert n == codes.shape[0]
    assert decoder._multiset_equal(read_lines_file(os.path.join(d, "dec_out")), codes)


@pytest.mark.parametrize("argv", [["-l", "1"], ["--device", "cuda"]])
def test_cli_refuses_what_it_cannot_run(se_archives, argv, monkeypatch):
    """cuda without a card is refused, not silently run on the CPU; -l N
    (two-pass matching) runs and writes the reference's archive (device
    sweeps in both packages), which differs from the single-pass one."""
    import torch

    d, _ = se_archives
    src = os.path.join(d, "in.fastq")
    if "-l" in argv:
        monkeypatch.setattr(ref_scs, "_HOST_SWEEP_MAX", 0)
        monkeypatch.setattr(port_scs, "_HOST_SWEEP_MAX", 0)
        ref, port = os.path.join(d, "l1.ref.pgtc"), os.path.join(d, "l1.port.pgtc")
        assert ref_cli.main(argv + ["-i", src, ref]) == 0
        assert port_cli.main(["--device", "cpu"] + argv + ["-i", src, port]) == 0
        with open(ref, "rb") as a, open(port, "rb") as b:
            got = b.read()
            assert got == a.read()
        with open(os.path.join(d, "port.pgtc"), "rb") as f:
            assert got != f.read()     # -l 1 takes other matches than -l 0
        return
    if torch.cuda.is_available():
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        port_cli.main(argv + ["-i", src, os.path.join(d, "never.pgtc")])
    assert not os.path.exists(os.path.join(d, "never.pgtc"))
