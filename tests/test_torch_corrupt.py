"""The port's copy of the decoder on malformed archives: tests/test_corrupt.py's
seven inputs, built from an archive the port wrote on the CPU. Every one must
raise `pgrc_tpu_torch.PgtcFormatError` (the port's own class), never an
AssertionError or an error of an inner layer; and the port's pure-Python rANS
decoder refuses malformed streams with ValueError (tests/test_streams.py's
`test_rans_malformed_fails_cleanly`)."""
import numpy as np
import pytest
import torch

from pgrc_tpu_torch import PgtcFormatError
from pgrc_tpu_torch.archive import decoder, encoder
from pgrc_tpu_torch.config import PgRCParams
from pgrc_tpu_torch.streams import rans_py
from test_roundtrip import synth_fastq


@pytest.fixture(scope="module")
def archive_bytes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corrupt")
    src = str(tmp / "in.fastq")
    synth_fastq(src, 400, 80, 4000, seed=11)
    out = str(tmp / "a.pgtc")
    encoder.encode(PgRCParams(src_fastq=src, output=out), device=torch.device("cpu"))
    with open(out, "rb") as f:
        return f.read()


def _expect_format_error(tmp_path, data: bytes, name: str):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    with pytest.raises(PgtcFormatError):
        decoder.load(p)


def test_not_an_archive(tmp_path):
    _expect_format_error(tmp_path, b"garbage data not pgtc", "bad.pgtc")


def test_empty_file(tmp_path):
    _expect_format_error(tmp_path, b"", "empty.pgtc")


def test_magic_only(tmp_path):
    _expect_format_error(tmp_path, b"PGTC", "magic.pgtc")


def test_bad_version(tmp_path, archive_bytes):
    data = bytearray(archive_bytes)
    data[4] = 9
    _expect_format_error(tmp_path, bytes(data), "ver.pgtc")


@pytest.mark.parametrize("frac", [0.3, 0.6, 0.9, 0.99])
def test_truncated(tmp_path, archive_bytes, frac):
    cut = archive_bytes[: int(len(archive_bytes) * frac)]
    _expect_format_error(tmp_path, cut, f"trunc_{frac}.pgtc")


@pytest.mark.parametrize("seed", range(8))
def test_flipped_bytes(tmp_path, archive_bytes, seed):
    """One flipped byte past the fixed header: PgtcFormatError, or a parse
    and a decode that raise no internal error."""
    rng = np.random.default_rng(seed)
    data = bytearray(archive_bytes)
    pos = int(rng.integers(16, len(data)))
    data[pos] ^= int(rng.integers(1, 256))
    p = str(tmp_path / f"flip_{seed}.pgtc")
    with open(p, "wb") as f:
        f.write(bytes(data))
    try:
        decoder._decode_all_reads(decoder.load(p))
    except PgtcFormatError:
        pass
    except AssertionError as e:  # pragma: no cover - the failure we forbid
        pytest.fail(f"corrupt archive raised AssertionError: {e}")


def test_zeroed_stream_area(tmp_path, archive_bytes):
    data = bytearray(archive_bytes)
    data[len(data) // 2 :] = bytes(len(data) - len(data) // 2)
    _expect_format_error(tmp_path, bytes(data), "zeroed.pgtc")


def test_rans_malformed_fails_cleanly():
    with pytest.raises(ValueError):
        rans_py.decode(b"\xff\xff" + b"\x00" * 10, 5)
    ok = rans_py.encode(b"hello world" * 100)
    assert rans_py.decode(ok, 1100) == b"hello world" * 100
    with pytest.raises(ValueError):
        rans_py.decode(ok[: len(ok) // 2], 1100)
