"""The port's benches (``chromosight_torch.bench``) on the CPU,
against the JAX system's: ``bench_torch.py``'s one-line contract with the
genome, link and baselines stubbed (as ``tests/test_bench_contract.py``
holds ``bench.py``), the baselines and the genome file against
``bench.py``'s and ``tools/make_synthetic_cool.py``'s, a real CPU run of
the detect bench at a small size, the quantify and ``--inter`` benches
against the JAX command line, and the BASELINE rows on
``data_test/example.cool`` against the JAX package's ``main``."""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import runpy
import subprocess
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import chromosight_torch.bench.detect as tbench
import chromosight_torch.kernels as ck
import chromosight_torch.observability as observability
import chromosight_torch.runtime.contact_map as contact_map
from chromosight_torch.bench import baseline, baseline_configs, genome, inter, quantify
from torch_parity import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
CONTRACT_KEYS = ("metric", "value", "unit", "vs_baseline", "wall_s", "walls_s", "baseline",
                 "baseline_slice_s", "warm_compile_load_s", "recall_planted_loops", "stage_s",
                 "link", "compute", "device", "peak_memory_bytes", "idle_share")
# the counts of BASELINE_RESULTS.md:7-14 for the rows on the example map
EXAMPLE_ROWS = {"1 loops detect example.cool (raw norm)": 85, "2 quantify example.bed2": 53,
                "3 borders detect -i 2": 57, "3 hairpins detect -i 2": 55,
                "5b detect --inter (example.cool)": 90}
COORDS = ["chrom1", "start1", "end1", "chrom2", "start2", "end2"]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", ROOT / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


@pytest.fixture
def small_bench(tmp_path, monkeypatch):
    """The bench's sizes cut to two 3,000-bin chromosomes, its cache in
    ``tmp_path``."""
    monkeypatch.setenv("CHROMOSIGHT_BENCH_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("CHROMOSIGHT_BENCH_GENOME_BINS", "6000")
    monkeypatch.setenv("CHROMOSIGHT_BENCH_GENOME_CHROMS", "2")
    monkeypatch.setenv("CHROMOSIGHT_BENCH_BASELINE_BINS", "1000")
    monkeypatch.setenv("CHROMOSIGHT_REFERENCE_DIR", str(tmp_path / "no_reference"))
    return tmp_path / "cache"


def _stub(monkeypatch, tmp_path, detect, engine):
    cool = tmp_path / "g.cool"
    cool.write_bytes(b"")
    monkeypatch.setattr(tbench, "ensure_genome", lambda: cool)
    monkeypatch.setattr(tbench, "measure_link", lambda device: (25e6, 25e6, 0.03))
    monkeypatch.setattr(tbench, "run_detect", detect)
    monkeypatch.setattr(tbench, "baseline_band", lambda *a: (np.zeros((8, 4)), np.zeros(8, bool)))
    monkeypatch.setattr(tbench, "run_reference_engine", engine)
    monkeypatch.setattr(tbench, "run_baseline", lambda *a: (0.25, 3))


def test_bench_torch_prints_one_contract_json_line(tmp_path, monkeypatch, capsys):
    """``tests/test_bench_contract.py``'s first test, against
    ``bench_torch.py``: one stdout line with the contract keys."""
    bench = _load("bench_torch.py")

    def fake_detect(cool_path, prefix, device):
        pd.DataFrame(
            {"chrom1": ["c1"], "start1": [0], "start2": [0], "bin1": [0], "bin2": [0],
             "score": [0.9]}
        ).to_csv(str(prefix) + ".tsv", sep="\t", index=False)

    _stub(monkeypatch, tmp_path, fake_detect, lambda *a, **k: 0.5)
    bench.main(device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, "bench stdout must be exactly one line"
    rec = json.loads(out[0])
    for key in CONTRACT_KEYS:
        assert key in rec, key
    assert rec["unit"] == "windows/s"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert len(rec["walls_s"]) in (2, 3)
    assert rec["wall_s"] == min(rec["walls_s"])
    assert "attributable_s" in rec["link"]
    assert rec["baseline"].startswith("reference chromosight")
    assert rec["calls"]["n"] == 1 and rec["device"] == "cpu"


def test_bench_torch_falls_back_to_reimplementation(tmp_path, monkeypatch, capsys):
    """``tests/test_bench_contract.py``'s second test, against
    ``bench_torch.py``: the same-math reimplementation where the reference
    engine returns None, and no recall without a truth file."""
    bench = _load("bench_torch.py")
    _stub(monkeypatch, tmp_path, lambda *a: None, lambda *a, **k: None)
    bench.main(device="cpu")
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["baseline"] == "reference-formulation reimplementation"
    assert rec["recall_planted_loops"] is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the bench would run")
def test_bench_torch_raises_without_a_card(tmp_path):
    """``python3 bench_torch.py`` without a card exits non-zero before it
    writes a genome, and prints nothing on stdout."""
    env = dict(os.environ, CHROMOSIGHT_BENCH_CACHE=str(tmp_path / "cache"),
               CHROMOSIGHT_BENCH_GENOME_BINS="6000", CHROMOSIGHT_BENCH_GENOME_CHROMS="2",
               PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "torch.cuda.is_available() is False" in res.stderr
    assert not (tmp_path / "cache").exists()


@pytest.mark.parametrize("trans_density", [0.0, 1e-3], ids=["cis", "trans"])
def test_genome_file_matches_the_tool(tmp_path, monkeypatch, trans_density):
    """``genome.ensure_genome`` writes what ``tools/make_synthetic_cool.py``
    writes for the same arguments: the same chromosomes, bins and pixels,
    weights bit for bit, the same truth file."""
    monkeypatch.setenv("CHROMOSIGHT_BENCH_CACHE", str(tmp_path))
    path = genome.ensure_genome(2, 2000, trans_density, seed=1)
    assert path == genome.genome_path(2, 2000, trans_density)
    tool_path = str(tmp_path / "tool.cool")
    argv = ["make_synthetic_cool.py", tool_path, "--bins", "2000", "--chroms", "2", "--seed", "1",
            "--trans-density", str(trans_density)]
    monkeypatch.setattr(sys, "argv", argv)
    _quiet(runpy.run_path, str(ROOT / "tools" / "make_synthetic_cool.py"), run_name="__main__")
    with h5py.File(path, "r") as ours, h5py.File(tool_path, "r") as tool:
        for name in ("chroms/name", "chroms/length", "bins/chrom", "bins/start", "bins/end",
                     "pixels/bin1_id", "pixels/bin2_id", "pixels/count", "indexes/bin1_offset"):
            assert np.array_equal(ours[name][:], tool[name][:]), name
        assert ours["bins/weight"][:].tobytes() == tool["bins/weight"][:].tobytes()
    truth = genome.truth_path(path).read_bytes()
    assert truth == pathlib.Path(tool_path + ".truth.bed2d").read_bytes()
    assert truth.count(b"\n") == 6


def test_baselines_match_bench_py(tmp_path, monkeypatch):
    """``baseline.baseline_band`` and ``run_baseline`` against
    ``bench.py``'s on a seeded 2 x 2,000 genome: equal bands and missing
    rows, equal candidate counts; both reference engines decline without
    the reference tree."""
    monkeypatch.setenv("CHROMOSIGHT_BENCH_CACHE", str(tmp_path))
    jax_bench = _load("bench.py")
    path = genome.ensure_genome(2, 2000, seed=2)
    band, missing = baseline.baseline_band(path, 2000, 512)
    jax_band, jax_missing = jax_bench.baseline_band(path, 2000, 512)
    assert band.dtype == jax_band.dtype and np.array_equal(band, jax_band)
    assert np.array_equal(missing, jax_missing)
    K = np.asarray(ck.loops["kernels"][0])
    cand = baseline.run_baseline(band, missing, K, genome.MAX_DIST)[1]
    assert cand == jax_bench.run_baseline(jax_band, jax_missing, K, genome.MAX_DIST)[1] > 0
    absent = str(tmp_path / "no_reference")
    assert baseline.run_reference_engine(band, missing, K, 400, absent) is None
    assert jax_bench.run_reference_engine(band, missing, K, 400, absent) is None


def test_reference_engine_runs_only_where_named(tmp_path, monkeypatch):
    """``run_reference_engine`` has no default tree: with neither
    ``reference_dir`` nor ``CHROMOSIGHT_REFERENCE_DIR`` it returns None,
    and a tree named either way is imported and timed."""
    tree = tmp_path / "reference"
    utils = tree / "chromosight" / "utils"
    utils.mkdir(parents=True)
    for init in (tree / "chromosight", utils):
        (init / "__init__.py").write_text("")
    (utils / "preprocessing.py").write_text(
        "def make_missing_mask(shape, **kwargs):\n    return None\n")
    (utils / "detection.py").write_text(
        "import numpy as np\n"
        "def normxcorr2(signal, kernel, **kwargs):\n"
        "    return np.ones(signal.shape[0]), None\n")
    for name in [m for m in sys.modules if m == "chromosight" or m.startswith("chromosight.")]:
        monkeypatch.delitem(sys.modules, name)
    band, missing = np.eye(8, 4), np.zeros(8, bool)
    K = np.ones((3, 3))
    monkeypatch.delenv("CHROMOSIGHT_REFERENCE_DIR", raising=False)
    try:
        assert baseline.run_reference_engine(band, missing, K, 4) is None
        assert baseline.run_reference_engine(band, missing, K, 4, str(tree)) >= 0
        monkeypatch.setenv("CHROMOSIGHT_REFERENCE_DIR", str(tree))
        assert baseline.run_reference_engine(band, missing, K, 4) >= 0
        assert str(tree) not in sys.path
    finally:
        for name in [m for m in sys.modules if m == "chromosight" or m.startswith("chromosight.")]:
            del sys.modules[name]


def test_detect_bench_runs_on_the_cpu(small_bench):
    """A real ``device="cpu"`` run of the detect bench in a subprocess at
    2 x 3,000 bins: exactly one stdout line, the planted loops' recall,
    device "cpu" and every device-rate field null."""
    code = "from chromosight_torch.bench.detect import main; main(device='cpu')"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert len(lines) == 1, res.stdout
    rec = json.loads(lines[0])
    for key in CONTRACT_KEYS:
        assert key in rec, key
    assert rec["device"] == "cpu" and rec["baseline"] == "reference-formulation reimplementation"
    assert rec["recall_planted_loops"] is not None and rec["recall_planted_loops"] > 0.5
    assert rec["value"] > 0 and rec["wall_s"] == min(rec["walls_s"])
    assert rec["calls"]["n"] > 0 and rec["stage_s"]["correlate"] > 0
    link, compute = rec["link"], rec["compute"]
    for field in ("up_MBps", "down_MBps", "rtt_ms", "attributable_s"):
        assert link[field] is None, field
    assert link["upload_MB"] > 0
    for field in ("peak", "mfu_detect_stage", "mfu_e2e", "hbm_util_detect_stage_min"):
        assert compute[field] is None, field
    assert compute["detect_stage"]["tflops_per_s"] is None and compute["chip"] == "cpu"
    assert compute["per_program"]["band_normxcorr"]["dispatches"] == 2
    assert rec["peak_memory_bytes"] is None and rec["idle_share"] is None
    assert (small_bench / "genome_3000x2.cool").exists()


def test_quantify_bench_matches_jax(small_bench, capsys):
    """The quantify bench scores the planted loops of the bench genome as
    the JAX command line scores them."""
    from chromosight_tpu.cli.main import main as jax_main

    quantify.main(device="cpu")
    rec = json.loads(capsys.readouterr().out.strip())
    path = genome.ensure_genome()
    truth = genome.truth_path(path)
    prefix = str(small_bench.parent / "jax_q")
    assert _quiet(jax_main, ["quantify", "--no-plotting", str(truth), str(path), prefix]) == 0
    ref = pd.read_csv(prefix + ".tsv", sep="\t")
    assert rec["n_coords"] == len(ref) == truth.read_bytes().count(b"\n")
    assert rec["n_scored"] == int(ref["score"].notna().sum()) > 0
    assert rec["median_score"] == pytest.approx(float(np.nanmedian(ref["score"])), abs=1e-3)
    assert len(rec["walls_s"]) == 2 and rec["device"] == "cpu"


@pytest.mark.parametrize("engine", ["dense", "tiled"])
def test_inter_bench_matches_jax(tmp_path, monkeypatch, capsys, engine):
    """The ``--inter`` bench on a 2 x 2,000 trans genome: one line a rep,
    each with the JAX command line's number of calls; the trans map on the
    dense engine, and on the tiled engine (each package's dense limit
    lowered to 50), which the 50,000-bin trans maps of BASELINE 5c take."""
    from chromosight_tpu.cli.main import main as jax_main

    monkeypatch.setenv("CHROMOSIGHT_BENCH_CACHE", str(tmp_path))
    if engine == "tiled":
        monkeypatch.setattr(contact_map, "DENSE_LIMIT", 50)
        monkeypatch.setenv("CHROMOSIGHT_TPU_DENSE_LIMIT", "50")
    path = str(genome.ensure_genome(2, 2000, genome.TRANS_DENSITY, seed=4))
    records = inter.main([path, "2"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in lines] == records and len(records) == 2
    prefix = str(tmp_path / "jax_inter")
    assert _quiet(jax_main, ["detect", "--no-plotting", "-I", path, prefix]) == 0
    n_ref = len(pd.read_csv(prefix + ".tsv", sep="\t"))
    assert [r["calls"] for r in records] == [n_ref, n_ref] and n_ref > 0
    assert all(r["rc"] == 0 and r["device"] == "cpu" for r in records)
    assert (observability.counters().get("tiles: scanned", 0) > 0) == (engine == "tiled")


@pytest.mark.parametrize("row", list(EXAMPLE_ROWS))
def test_baseline_rows_match_jax(tmp_path, row):
    """Rows 1, 2, 3 and 5b of the BASELINE runner on the example map: the
    row runs, counts ``BASELINE_RESULTS.md``'s patterns, and its table has
    the coordinates the JAX package's ``main`` writes for the same argv
    (scores within 5e-5)."""
    from chromosight_tpu.cli.main import main as jax_main

    rows = {name: (argv, prefix) for name, argv, prefix in baseline_configs.config_rows(tmp_path)}
    assert list(rows) == list(EXAMPLE_ROWS)
    argv, prefix = rows[row]
    wall, status = _quiet(baseline_configs.run, argv, "cpu")
    assert status == "ok" and wall > 0
    assert baseline_configs.count_rows(prefix) == EXAMPLE_ROWS[row]
    jax_prefix = str(tmp_path / "jax")
    assert _quiet(jax_main, [*argv[:-1], jax_prefix]) == 0
    ours = pd.read_csv(prefix + ".tsv", sep="\t")
    ref = pd.read_csv(jax_prefix + ".tsv", sep="\t")
    assert len(ours) == len(ref)
    assert ours[COORDS].equals(ref[COORDS])
    assert np.allclose(ours["score"], ref["score"], atol=5e-5, equal_nan=True)


def test_baseline_configs_rows_and_table(tmp_path):
    """The runner's rows in the JAX runner's order with both genomes
    given (row 4 on a copy in the work directory), and its table."""
    rows = baseline_configs.config_rows(tmp_path, "g.cool", "t.cool")
    names = [name.split()[0] for name, _, _ in rows]
    assert names == ["1", "2", "3", "3", "4", "5", "5c", "5b"]
    assert rows[4][1][-2] == f"{tmp_path}/genome_force.cool"
    results = [{"name": name, "wall_s": 1.0, "status": "ok", "patterns": 3}
               for name, _, _ in rows]
    text = baseline_configs.table(results, "cpu")
    assert text.count("| ok | 3 |") == 8 and "on cpu." in text


def test_trans_genome_shares_the_cis_genome(tmp_path, monkeypatch):
    """The trans genome (BASELINE 5c) holds the cis genome's contacts and
    weights, bit for bit (the trans contacts are drawn after every
    chromosome, and ICE balances cis contacts only), so ``detect -I`` of it
    calls what ``detect`` of the cis genome calls when no trans call
    passes: on the port, and on the JAX package (2 x 2,000 bins)."""
    from chromosight_tpu.cli.main import main as jax_main
    from chromosight_torch.cli.main import main as torch_main
    from chromosight_torch.io.source import CoolSource

    monkeypatch.setenv("CHROMOSIGHT_BENCH_CACHE", str(tmp_path))
    cis = CoolSource(str(genome.ensure_genome(2, 2000, seed=5)))
    trans = CoolSource(str(genome.ensure_genome(2, 2000, genome.TRANS_DENSITY, seed=5)))
    assert cis.weights.tobytes() == trans.weights.tobytes()
    b1, b2, ct = trans._pixels(0, trans.nnz)
    same_chrom = np.searchsorted(trans._chrom_offset, b1, "right") == np.searchsorted(
        trans._chrom_offset, b2, "right")
    for ours, theirs in zip(cis._pixels(0, cis.nnz), (b1, b2, ct)):
        assert np.array_equal(ours, theirs[same_chrom])
    assert not same_chrom.all()
    tables = {}
    for name, main, path, flags in (
            ("port -I", torch_main, trans, ["-I"]), ("port", torch_main, cis, []),
            ("jax -I", jax_main, trans, ["-I"]), ("jax", jax_main, cis, [])):
        prefix = str(tmp_path / name.replace(" ", "_"))
        kwargs = {"device": "cpu"} if main is torch_main else {}
        argv = ["detect", "--no-plotting", *flags, path.path, prefix]
        assert _quiet(main, argv, **kwargs) == 0
        tables[name] = pd.read_csv(prefix + ".tsv", sep="\t")[COORDS]
    assert len(tables["port"]) > 0
    assert all(table.equals(tables["port"]) for table in tables.values())
