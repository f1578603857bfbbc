"""The harness's data, readers, profiler arithmetic, reference and imports,
on the CPU."""
import ast
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, make_root
from pgrc_bench import devtrace, gen, reference, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "pgrc_tpu"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ------------------------------------------------------------ the generator

@pytest.mark.parametrize("kw", [
    dict(n_reads=5000, read_len=100, genome_len=15000, seed=5, repeats=True),
    dict(n_reads=12000, read_len=100, genome_len=40000, seed=2**31 + 17),
    dict(n_reads=900, read_len=37, genome_len=9000, seed=0, repeats=True),
])
def test_generator_writes_synth_fastq_bytes(tmp_path, kw):
    from pgrc_tpu_torch.synth import synth_fastq

    a = synth_fastq(str(tmp_path / "o1.fq"), pair=str(tmp_path / "o2.fq"), **kw)
    b = gen.synth_fastq(str(tmp_path / "n1.fq"), pair=str(tmp_path / "n2.fq"), **kw)
    assert np.array_equal(a, b)
    assert _sha(tmp_path / "o1.fq") == _sha(tmp_path / "n1.fq")
    assert _sha(tmp_path / "o2.fq") == _sha(tmp_path / "n2.fq")


def test_genome_seed_fixes_the_genome(tmp_path):
    """With `genome_seed` every seed samples reads of one genome: a read of
    one seed lies on the genome that another seed's reads cover."""
    kw = dict(n_reads=20000, read_len=50, genome_len=500, repeats=False, genome_seed=7,
              error_rate=0.0, lq_share=0.0)
    a = gen.synth_fastq(str(tmp_path / "a.fq"), seed=1, **kw)
    b = gen.synth_fastq(str(tmp_path / "b.fq"), seed=2, **kw)
    c = gen.synth_fastq(str(tmp_path / "c.fq"), seed=1, **dict(kw, genome_seed=8))
    assert not np.array_equal(a, b)
    rc = lambda m: gen.COMPL_VAL[m[:, ::-1]]  # noqa: E731
    seen = {r.tobytes() for r in np.concatenate([b, rc(b)])}
    assert all(r.tobytes() in seen for r in a[:50])
    assert not all(r.tobytes() in seen for r in c[:50])


def test_generator_profile(tmp_path):
    path = str(tmp_path / "r.fq")
    codes = gen.synth_fastq(path, 20000, 100, 50000, seed=3, lq_share=0.4, n_share=0.05)
    lines = open(path, "rb").read().split(b"\n")
    quals = lines[3::4][:20000]
    low = sum(q.endswith(b"#") for q in quals) / 20000
    assert abs(low - 0.4) < 0.02
    assert abs((codes == 4).any(axis=1).mean() - 0.05) < 0.01
    assert np.array_equal(reference.fastq_codes(path), codes)


# ------------------------------------------------------- BENCHMARK.json

def test_benchmark_entries_resolve_and_keep_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "pgrc_bench/run.py"] and b["paths"] == ["pgrc_bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("pgrc_bench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        assert all(k in cfg["full_scale"] for k in c["reduced"])
        assert cfg["reads"] * cfg["read_len"] / cfg["genome_len"] == cfg["coverage"]
        assert any(w["config"] == c["name"] for w in b["workloads"])
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert run.load_cell(ROOT, w["name"])["traffic"]["lq_share"] > 0
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(run.load_reader(ROOT, m["name"]))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"] and "bound" not in m
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for w in b["workloads"]:
        assert {m["name"] for m in run.cell_metrics(b, w, False)} == e2e
    assert len(json.dumps(b)) < 64 * 1024


def test_added_by_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added as
    new files and entries are found and run, with no edit of the harness."""
    root = str(tmp_path)
    bench = make_root(root)
    d = os.path.join(root, "pgrc_bench")
    with open(os.path.join(d, "configs", "tiny_se.json")) as f:
        cfg = json.load(f)
    cfg.update(read_len=80, reads=5000, genome_len=10000)
    with open(os.path.join(d, "configs", "tiny80.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(d, "traffic", "n1.json"), "w") as f:
        json.dump({"why": "1% of reads carry an N", "lq_share": 0.12, "error_rate": 0.004,
                   "n_share": 0.01}, f)
    with open(os.path.join(d, "metrics", "stage_s.bad.py"), "w") as f:
        f.write("def read(record):\n"
                "    return sum(e['stage_times']['bad'] for e in record['encodes'])"
                " / len(record['encodes'])\n")
    bench["configs"].append(dict(bench["configs"][0], name="tiny80",
                                 file="pgrc_bench/configs/tiny80.json"))
    bench["workloads"].append({"name": "tiny80.n1", "config": "tiny80", "traffic": "n1",
                               "chips": 1, "why": "a test's added cell"})
    bench["per_layer"].append({"name": "stage_s.bad", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "sweep",
                               "moves": "encode_mbases_s", "workloads": ["tiny80.n1"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    spec = run.load_cell(root, "tiny80.n1")
    assert spec["config"]["read_len"] == 80 and spec["traffic"]["n_share"] == 0.01
    names = [m["name"] for m in run.cell_metrics(spec["bench"], spec["cell"], True)]
    assert "stage_s.bad" in names
    assert "stage_s.bad" not in [m["name"] for m in run.cell_metrics(
        spec["bench"], run.load_cell(root, "tiny_se.lq12")["cell"], True)]
    r = run.run_cell(root, "tiny80.n1", 11, 0, True, device="cpu")
    assert r["correct"] and r["metrics"]["stage_s.bad"]["value"] >= 0


# ------------------------------------------------------------ the readers

def _record():
    st = {"input": 0.5, "div": 0.1, "pgdiv": 2.0, "good": 0.0, "match": 1.5, "bad": 0.1,
          "order": 0.4, "pgseq": 1.0}
    encodes = [{"start_s": 0.0, "end_s": 6.0, "bases": 2e8, "archive_bytes": 3_500_000,
                "stage_times": st, "stage_rss_mb": {"pgdiv": 5000.0, "match": 5300.0}},
               {"start_s": 6.0, "end_s": 14.0, "bases": 2e8, "archive_bytes": 3_500_000,
                "stage_times": dict(st, pgdiv=3.0), "stage_rss_mb": {"pgdiv": 5200.0, "match": 5100.0}}]
    return {"setup_s": 21.5, "encodes": encodes, "rss_base_mb": 4750.0,
            "rss_warmup_peak_mb": 5400.0, "rss_peak_mb": 5600.0,
            "trace": {"busy_s": 0.25, "window_s": 12.5, "kernel_s": 0.1}}


@pytest.mark.parametrize("name,want", [
    ("encode_mbases_s", 4e8 / 14 / 1e6), ("bits_per_base", 0.14), ("encode_rss_mb", 650.0),
    ("setup_s", 21.5), ("stage_s.ingest", 0.6), ("stage_s.pgdiv", 2.5), ("stage_s.chain", 0.9),
    ("stage_s.match", 1.5), ("stage_s.coding", 1.4), ("stage_rss_mb.pgdiv", 350.0),
    ("stage_rss_mb.match", 450.0), ("kernel_ms", 50.0), ("device_idle_share", 0.98),
])
def test_metric_reader(name, want):
    assert run.load_reader(ROOT, name)(_record()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["stage_rss_mb.pgdiv", "stage_rss_mb.match", "kernel_ms",
                                  "device_idle_share"])
def test_reader_with_nothing_to_read_returns_none(name):
    rec = _record()
    rec["trace"] = None
    for e in rec["encodes"]:
        e["stage_rss_mb"] = None
    assert run.load_reader(ROOT, name)(rec) is None


# ------------------------------------------------------ profiler arithmetic

def test_union_and_gaps():
    busy = devtrace.union([(1, 2), (1.5, 3), (5, 6), (0, 0.5), (5.5, 5.7)])
    assert busy == [(0, 0.5), (1, 3), (5, 6)]
    assert devtrace.gaps(busy, 0, 7) == [(0.5, 1), (3, 5), (6, 7)]
    assert devtrace.gaps(busy, 1.5, 5.5) == [(3, 5)]


def test_summarise_splits_idle_by_stage():
    spans = [(0.0, 10.0), (11.0, 20.0)]
    times = [{"input": 2.0, "pgdiv": 5.0}, {"input": 1.0, "pgdiv": 4.0}]
    dev = [("kern_a", 2.5, 3.0), ("Memcpy HtoD", 2.8, 3.5), ("kern_b", 12.0, 12.5),
           ("kern_a", 30.0, 31.0)]
    s = devtrace.summarise(dev, spans, times)
    assert s["window_s"] == 20.0
    assert s["busy_s"] == pytest.approx(1.5)
    assert s["kernel_s"] == pytest.approx(1.0)
    idle = s["idle_by_stage"]
    assert idle["input"] == pytest.approx(2.0 + 1.0)
    assert idle["pgdiv"] == pytest.approx(4.0 + 3.5)
    assert idle["chain"] == pytest.approx(3.0 + 4.0)
    assert idle["harness"] == pytest.approx(1.0)
    assert sum(idle.values()) == pytest.approx(20.0 - 1.5)
    assert s["idle_gaps"][0] == ["chain", pytest.approx(4.0)]
    assert s["device_ops"] == [["Memcpy HtoD (x1)", pytest.approx(0.7)],
                               ["kern_a (x1)", pytest.approx(0.5)],
                               ["kern_b (x1)", pytest.approx(0.5)]]


def test_chain_lies_after_stage_5():
    """What the stages leave of an encode's wall is placed after `bad`, where
    the encoder waits for its stage-7 self-match, not at the encode's end."""
    spans = devtrace.stage_spans([(0.0, 10.0)], [{"input": 1.0, "bad": 2.0, "order": 3.0}])
    assert spans == [("input", 0.0, 1.0), ("bad", 1.0, 3.0), ("chain", 3.0, 7.0),
                     ("order", 7.0, 10.0)]
    s = devtrace.summarise([("k", 8.0, 9.0)], [(0.0, 10.0)], [{"input": 1.0, "bad": 2.0,
                                                               "order": 3.0}])
    assert s["idle_by_stage"] == {"input": 1.0, "bad": 2.0, "chain": 4.0, "order": 2.0}


# ------------------------------------------------------------ the reference

def _keys(rows):
    return np.sort(reference.keys([np.array(rows, dtype=np.uint8)]))


def test_multiset_difference():
    a = _keys([[1, 2], [1, 2], [3, 4]])
    assert reference.multiset_difference(a, a) == 0
    assert reference.multiset_difference(a, _keys([[3, 4], [1, 2], [1, 2]])) == 0
    assert reference.multiset_difference(a, _keys([[1, 2], [3, 4], [3, 4]])) == 2
    assert reference.multiset_difference(a, _keys([[1, 2], [3, 4]])) == 1
    assert reference.multiset_difference(a, _keys([[1, 2, 0], [1, 2, 0], [3, 4, 0]])) == 6
    assert reference.multiset_difference(a, a[:0]) == 3


def test_pair_keys_keep_the_pairing():
    m1 = np.array([[0, 1], [2, 3]], dtype=np.uint8)
    m2 = np.array([[1, 1], [2, 2]], dtype=np.uint8)
    want = np.sort(reference.keys([m1, m2]))
    assert reference.multiset_difference(want, np.sort(reference.keys([m1[::-1], m2[::-1]]))) == 0
    assert reference.multiset_difference(want, np.sort(reference.keys([m1, m2[::-1]]))) == 4


@pytest.mark.parametrize("n", [1, 2, 9, 12000])
def test_fastq_codes(tmp_path, n):
    path = str(tmp_path / "r.fq")
    codes = gen.synth_fastq(path, n, 100, 30000, seed=n, n_share=0.1)
    assert np.array_equal(reference.fastq_codes(path), codes)


@pytest.fixture(scope="module")
def tiny_archive(tmp_path_factory):
    import torch
    from pgrc_tpu_torch.archive import encoder

    d = tmp_path_factory.mktemp("arch")
    files = [str(d / "r1.fq"), str(d / "r2.fq")]
    gen.synth_fastq(files[0], 3000, 100, 9000, seed=4, pair=files[1], repeats=True)
    out = {}
    for name, fs in (("se", files[:1]), ("pe", files)):
        params = run.params_for(run.parse_flags([]), fs, str(d / f"{name}.pgtc"))
        encoder.encode(params, device=torch.device("cpu"))
        out[name] = (str(d / f"{name}.pgtc"), fs)
    return out


@pytest.mark.parametrize("flags,pe", [([], False), ([], True), (["-o"], False),
                                      (["-l", "2", "-c", "3"], False)])
def test_params_are_the_cli_s(tmp_path, flags, pe):
    """The harness's parameters for a configuration's flags write the
    archive `pgrc_tpu_torch.cli` writes for the same flags."""
    import torch
    from pgrc_tpu_torch import cli
    from pgrc_tpu_torch.archive import encoder

    files = [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")]
    gen.synth_fastq(files[0], 2000, 100, 8000, seed=3, pair=files[1])
    files = files if pe else files[:1]
    assert cli.main(["--device", "cpu", *flags, "-i", *files, str(tmp_path / "cli.pgtc")]) == 0
    encoder.encode(run.params_for(run.parse_flags(flags), files, str(tmp_path / "h.pgtc")),
                   device=torch.device("cpu"))
    assert _sha(tmp_path / "cli.pgtc") == _sha(tmp_path / "h.pgtc")


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_reference_passes_a_sound_archive(tiny_archive, mode):
    path, files = tiny_archive[mode]
    assert reference.judge(path, reference.input_keys(files), len(files)) == 0


@pytest.mark.parametrize("mode", ["se", "pe"])
@pytest.mark.parametrize("damage", ["flip", "truncate", "empty"])
def test_reference_fails_a_damaged_archive(tiny_archive, tmp_path, mode, damage):
    path, files = tiny_archive[mode]
    data = bytearray(open(path, "rb").read())
    if damage == "flip":
        for at in range(len(data) // 3, len(data), 97):
            data[at] ^= 0x5A
    elif damage == "truncate":
        data = data[: len(data) * 2 // 3]
    else:
        data = data[:8]
    bad = str(tmp_path / "bad.pgtc")
    open(bad, "wb").write(bytes(data))
    want = reference.input_keys(files)
    try:
        assert reference.judge(bad, want, len(files)) > 0
    except Exception:   # an archive that does not decode fails too
        pass
    window = [{"archive": bad}]
    checks, failed = run.judge_window(window, files)
    assert failed == 1
    assert checks["reads_differ"]["value"] > 0 or checks["archives_failed"]["value"] > 0


# every coder the port's streams can name: (coder id, p1, p2)
CODERS = [(0, 0, 0), (1, 0, 0), (2, 2, 1), (2, 2, 4), (3, 19, 0), (4, 0, 1), (5, 0, 2),
          (6, 0, 0), (6, 2, 0), (7, 1, 128), (7, 3, 0), (8, 2, 2), (8, 3, 19), (9, 0, 0)]


@pytest.mark.parametrize("coder", CODERS, ids=lambda c: "-".join(map(str, c)))
def test_decoder_copy_reads_every_coder_of_the_port(coder):
    from pgrc_tpu_torch.streams.codecs import Codec as PortCodec

    from pgrc_bench.pgtc_decoder.streams.codecs import Codec

    rng = np.random.default_rng(7)
    vals = rng.integers(0, 6 if coder[0] == 6 else 5, size=300_000).astype(np.uint8)
    data = np.where(rng.random(vals.size) < 0.7, 0, vals).astype(np.uint8).tobytes()
    if coder[0] == 8:
        data = data * 40   # more than one block of the blocked wrapper
    packed = PortCodec(*coder).compress(data)
    assert Codec(*coder).decompress(packed, len(data)) == data


# --------------------------------------------------------------- imports

def _imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_neither_jax_nor_the_jax_package():
    files = [p for p in glob.glob(os.path.join(ROOT, "pgrc_bench", "**", "*.py"), recursive=True)]
    assert files
    for p in files:
        assert not (_imported_top_names(p) & FORBIDDEN), p
    ref = [os.path.join(ROOT, "pgrc_bench", "reference.py")] + glob.glob(
        os.path.join(ROOT, "pgrc_bench", "pgtc_decoder", "**", "*.py"), recursive=True)
    for p in ref:
        assert "pgrc_tpu_torch" not in _imported_top_names(p), p


def test_loaded_modules():
    """What the harness and the port load, and what the reference loads, by
    whole top-level names (`pgrc_tpu_torch` starts with `pgrc_tpu`)."""
    code = ("import sys; sys.path.insert(0, {root!r}); {imports}; "
            "import json; print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    harness = ("from pgrc_bench import run, control, faults; "
               "from pgrc_tpu_torch.archive import encoder; "
               "from pgrc_tpu_torch.kernels import build; import pgrc_tpu_torch.native")
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT, imports=harness)],
                         capture_output=True, text=True, check=True, cwd="/")
    top = set(json.loads(out.stdout))
    assert "pgrc_tpu_torch" in top and not (top & FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code.format(
        root=ROOT, imports="import pgrc_bench.reference")],
        capture_output=True, text=True, check=True, cwd="/")
    top = set(json.loads(out.stdout))
    assert not (top & (FORBIDDEN | {"pgrc_tpu_torch", "torch"}))


def _bare_copy(path, with_program):
    """BENCHMARK.json and the files under `paths`, with `se100_human` cut to
    6,000 reads; with the program beside them or not."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), path)
    shutil.copytree(os.path.join(ROOT, "pgrc_bench"), path / "pgrc_bench",
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    cfg_path = path / "pgrc_bench" / "configs" / "se100_human.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(reads=6000, genome_len=15000)
    cfg_path.write_text(json.dumps(cfg))
    if with_program:
        shutil.copytree(os.path.join(ROOT, "pgrc_tpu_torch"), path / "pgrc_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "*.so", "__pycache__"))
    return subprocess.run([sys.executable, "pgrc_bench/run.py", "--workload",
                           "se100_human.hq2", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=path, capture_output=True, text=True, timeout=600,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_result_without_the_program(tmp_path):
    p = _bare_copy(tmp_path, with_program=False)
    assert p.returncode != 0 and '"correct"' not in p.stdout
    assert "pgrc_tpu_torch" in p.stderr


def test_no_result_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _bare_copy(tmp_path, with_program=True)
    assert p.returncode == 3 and '"correct"' not in p.stdout
    assert "no result" in p.stderr
