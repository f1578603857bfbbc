"""bench_torch.py, the port's twin of bench.py, on the CPU: its inputs are
bench.py's byte for byte, the repeat genome (its one input that no other
test feeds the port) compresses to `pgrc_tpu`'s archive through the device
sweep's plain versions, and `main` prints bench.py's key set beside the
run's device fields."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import bench_torch
from pgrc_tpu.archive import encoder as ref_encoder
from pgrc_tpu.config import PgRCParams as RefParams
from pgrc_tpu.overlap import greedy_scs as ref_scs
from pgrc_tpu_torch import synth
from pgrc_tpu_torch.archive import decoder, encoder
from pgrc_tpu_torch.config import PgRCParams
from pgrc_tpu_torch.overlap import greedy_scs as port_scs
from pgrc_tpu_torch.utils import dna

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_R05 = os.path.join(ROOT, "BENCH_r05.json")


@pytest.mark.parametrize("seed,pair,repeats", [(7, True, False), (11, False, True)])
def test_synth_writes_bench_files(tmp_path, seed, pair, repeats):
    """bench.py's generator and the port's copy write the same bytes (seed 7
    with its pair file, seed 11 on the repeat genome) on bench.py's genome
    length for the read count."""
    n = 3000
    genome = max(n * 100 // 40, 200_000)
    files = {}
    for name, fn in (("bench", bench.synth_fastq), ("port", synth.synth_fastq)):
        src = str(tmp_path / f"{name}.fastq")
        mate = str(tmp_path / f"{name}_2.fastq") if pair else None
        codes = fn(src, n, 100, genome, seed=seed, pair=mate, repeats=repeats)
        files[name] = [Path(p).read_bytes() for p in (src, mate) if p] + [codes]
    for a, b in zip(files["bench"], files["port"]):
        if isinstance(a, bytes):
            assert a == b and len(a) > n * 200
        else:
            np.testing.assert_array_equal(a, b)


def test_repeat_genome_archive_equals_reference(tmp_path, monkeypatch):
    """The repeat genome (diverged ALU- and LINE-like copies, tandem
    repeats) at ~40x: the port's SE archive on the CPU is `pgrc_tpu`'s byte
    for byte, with the same matched count, and decodes to the input reads.
    Both packages take their device sweep (_HOST_SWEEP_MAX = 0), so the
    port's sweep kernels run as their plain versions."""
    monkeypatch.setattr(ref_scs, "_HOST_SWEEP_MAX", 0)
    monkeypatch.setattr(port_scs, "_HOST_SWEEP_MAX", 0)
    src = str(tmp_path / "rep.fastq")
    codes = synth.synth_fastq(src, 6000, 100, 15_000, seed=11, repeats=True)
    ref_out, port_out = str(tmp_path / "ref.pgtc"), str(tmp_path / "port.pgtc")
    ref_stats = ref_encoder.encode(RefParams(src_fastq=src, output=ref_out))
    port_stats = encoder.encode(PgRCParams(src_fastq=src, output=port_out),
                                device=torch.device("cpu"))
    with open(ref_out, "rb") as a, open(port_out, "rb") as b:
        assert a.read() == b.read()
    assert port_stats.matched_count == ref_stats.matched_count > 0
    assert port_stats.hq_count == ref_stats.hq_count
    n = decoder.decode_to_files(port_out, str(tmp_path / "dec"))
    raw = np.fromfile(str(tmp_path / "dec_out"), dtype=np.uint8)
    got = dna.SYM2VAL[raw.reshape(-1, 101)[:, :100]]
    assert n == codes.shape[0] and decoder._multiset_equal(got, codes)


def test_main_prints_bench_keys_and_device_fields(tmp_path, monkeypatch, capsys):
    """`main --device cpu` at a tiny size, the scale row off and a big row
    of 3,000 reads through its child processes: exit 0 and one JSON line
    with BENCH_r05's keys (but the scale row's) and the run's own fields."""
    for key, val in (("PGRC_BENCH_READS", "2000"), ("PGRC_BENCH_SCALE_READS", "0"),
                     ("PGRC_BENCH_BIG_READS", "3000"), ("PGRC_BENCH_TMP", str(tmp_path))):
        monkeypatch.setenv(key, val)
    monkeypatch.delenv("PGRC_BENCH_BIG", raising=False)
    assert bench_torch.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    with open(BENCH_R05) as f:
        want = {k for k in json.load(f)["parsed"] if not k.startswith("scale_")}
    assert want <= set(got) and "error" not in got
    assert got["reads"] == 2000 and got["big_reads"] == 3000
    assert got["device"] == {"platform": "cpu", "name": None, "power_limit": None,
                             "count": 0}
    assert set(got["versions"]) == {"python", "torch", "cuda", "nvcc"}
    assert list(got["codecs"])[0] == "zstandard"
    for row in ("", "pe_", "se_ord_", "repeat_", "big_"):
        assert len(got[f"{row}sha256"]) == 64
        assert got[f"{row}peak_device_mib"] is None   # no device on the CPU
    assert got["baseline_source"] in ("build-ref/PgRC -t 8", "build-ref/baseline.json",
                                      "BASELINE_LOCAL_MBASES_S")
    # each child's own peak RSS, not the parent's that ru_maxrss carries
    assert got["big_validate_rss_mb"] <= got["big_validate_ru_maxrss_mb"]
    assert got["big_trace"]["device_s"] is None


def test_peak_rss_sampler_sees_an_allocation(monkeypatch):
    """Where the kernel reports no VmHWM, PeakRss samples /proc/self/statm:
    a 256 MB array touched and freed between two reads shows in the peak."""
    import time

    monkeypatch.setattr(bench_torch, "vm_hwm_mb", lambda: None)
    peak = bench_torch.PeakRss(every=0.005)
    assert peak.source == "statm every 5 ms"
    before = bench_torch.rss_now_mb()
    a = np.ones(1 << 25)
    time.sleep(0.1)
    del a
    assert peak.mb() >= before + 200 > bench_torch.rss_now_mb() + 100


VALIDATE_CHILD = r"""
import sys
from pgrc_tpu_torch.archive import decoder
rep = decoder.validate(sys.argv[1], sys.argv[2])
n = decoder.decode_to_files(sys.argv[1], sys.argv[1] + ".dec")
assert rep["errors"] == 0 and rep["reads"] == n == 1500, (rep, n)
assert "torch" not in sys.modules, "the decoder imported torch"
print("ok")
"""


def test_validate_and_decode_never_import_torch(tmp_path):
    """The big row's validate child measures the validator's own RSS: the
    port's decoder and validator (host code) run without importing torch."""
    src, out = str(tmp_path / "in.fastq"), str(tmp_path / "a.pgtc")
    synth.synth_fastq(src, 1500, 100, 4000, seed=3)
    encoder.encode(PgRCParams(src_fastq=src, output=out), device=torch.device("cpu"))
    r = subprocess.run([sys.executable, "-c", VALIDATE_CHILD, out, src], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_main_fails_on_a_tripped_gate_after_every_row(tmp_path, monkeypatch, capsys):
    """A tripped gate (here the parent's RSS budget, set to 1 MB) exits 1
    with bench.py's error line, once every row has run: the figures of the
    rows after the gate's are under `partial`."""
    for key, val in (("PGRC_BENCH_READS", "1500"), ("PGRC_BENCH_SCALE_READS", "0"),
                     ("PGRC_BENCH_BIG", "0"), ("PGRC_BENCH_TMP", str(tmp_path))):
        monkeypatch.setenv(key, val)
    monkeypatch.setattr(bench_torch, "SCALE_RSS_MB", 1)
    assert bench_torch.main(["--device", "cpu"]) == 1
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["value"] == 0.0 and got["error"].startswith("peak RSS")
    assert got["partial"]["reads"] == 1500 and "baseline_source" in got["partial"]
