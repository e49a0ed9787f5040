"""The port's detect slice end to end on CPU: the 89-loop golden from the
cool file and its npz export, state carried over from the JAX package,
the preprocessed bands of --smooth-trend, --dump and --norm raw against
the JAX package's, the synthetic genome source, the options and
subcommands once refused as not ported, and the import boundary (no
jax, h5py or jsonschema; the Python API's modules and TUTORIAL's block
included)."""

import contextlib
import importlib.util
import io
import pathlib
import shutil
import subprocess
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import chromosight_tpu.kernels as ck
from chromosight_torch.cli.main import main
from chromosight_torch.detection import _band_correlate
from chromosight_torch.io.source import ArraySource, planted_recall
from chromosight_torch.runtime.genome import HicGenome
from chromosight_torch.state import contact_map_from_jax, kernel_config_from_jax
from chromosight_tpu.detection import _band_correlate as jax_band_correlate
from chromosight_tpu.runtime.genome import HicGenome as JaxHicGenome
from torch_parity import assert_pearson_close, torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
EXAMPLE_NPZ = DATA / "example_cool.npz"
EXAMPLE_COOL = ROOT / "data_test" / "example.cool"

# chromosight_tpu/cli/main.py TEST_LOG, up to the table line
GOLDEN_LOG = """pearson set to 0.3 based on config file.
max_dist set to 2000000 based on config file.
min_dist set to 20000 based on config file.
min_separation set to 5000 based on config file.
max_perc_undetected set to 50.0 based on config file.
max_perc_zero set to 10.0 based on config file.
Matrix already balanced, reusing weights
Preprocessing sub-matrices...
Detecting patterns...
89 patterns detected
Saving patterns in {prefix}.tsv
"""


@pytest.fixture(scope="module")
def detect_runs(tmp_path_factory):
    """The port's CLI detect on example.cool and on its npz export: output
    prefixes, and the stderr of the npz run."""
    out = tmp_path_factory.mktemp("detect")
    runs = {}
    for name, path in (("cool", ROOT / "data_test" / "example.cool"), ("npz", EXAMPLE_NPZ)):
        runs[name] = str(out / name)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main(["detect", "--no-plotting", str(path), runs[name]], device="cpu") == 0
    runs["stderr"] = err.getvalue()
    return runs


def test_detect_reproduces_golden_89_loops(detect_runs):
    golden = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    ours = pd.read_csv(detect_runs["cool"] + ".tsv", sep="\t")
    assert len(ours) == len(golden) == 89
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    g = golden.sort_values(key).reset_index(drop=True)
    o = ours.sort_values(key).reset_index(drop=True)
    for col in key + ["chrom1", "start1", "end1", "chrom2", "start2", "end2"]:
        assert (g[col] == o[col]).all(), col
    assert np.abs(g.score - o.score).max() < 5e-5
    assert np.abs(g.pvalue - o.pvalue).max() < 1e-6
    assert np.abs(g.qvalue - o.qvalue).max() < 1e-6


def test_detect_from_npz_is_byte_identical(detect_runs):
    for ext in (".tsv", ".json"):
        a = pathlib.Path(detect_runs["cool"] + ext).read_bytes()
        b = pathlib.Path(detect_runs["npz"] + ext).read_bytes()
        assert a == b, ext


def test_detect_stderr_matches_golden_log(detect_runs):
    err = detect_runs["stderr"]
    lines = [ln.split("\r")[-1].replace("\x1b[K", "") for ln in err.split("\n")]
    lines = [ln for ln in lines if ln and not ln.startswith(" [")]
    expected = GOLDEN_LOG.format(prefix=detect_runs["npz"]).strip().split("\n")
    assert lines[: len(expected)] == expected


@pytest.mark.parametrize(
    "flags,what",
    [
        (["--subsample", "0.5"], "--subsample"),
        (["--norm", "force"], "--norm force"),
    ],
)
def test_unported_options_raise(tmp_path, flags, what):
    """The options the port once refused as not ported now run: a
    subsampled detect, and ICE balancing from the npz (the weights
    recomputed and kept in memory); ``tests/test_torch_cli.py`` holds
    them against the JAX package."""
    argv = ["detect", "--no-plotting", *flags, str(EXAMPLE_NPZ), str(tmp_path / "x")]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv, device="cpu", rng=np.random.RandomState(0)) == 0
    calls = pd.read_csv(tmp_path / "x.tsv", sep="\t")
    assert len(calls) > 10 and calls.score.notna().all()
    if what == "--norm force":
        assert "Whole genome matrix balanced" in out.getvalue() and len(calls) == 89
    else:
        assert "50.0% contacts will be sampled" in err.getvalue() and len(calls) < 89


@pytest.mark.parametrize(
    "argv,what",
    [
        (["generate-config", "p"], "generate-config"),
        (["list-kernels"], "list-kernels"),
        (["test"], "test"),
    ],
)
def test_unported_subcommand_raises(tmp_path, monkeypatch, argv, what):
    """The subcommands the port once refused as not ported now run (the
    self-test offline, on the repository's example map)."""
    import chromosight_torch.cli.main as cli

    def offline(url, path):
        raise OSError("no network in this test")

    monkeypatch.setattr(cli, "download_file", offline)
    monkeypatch.chdir(tmp_path)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert main(argv, device="cpu") == 0
    if what == "generate-config":
        assert (tmp_path / "p.json").exists() and (tmp_path / "p.1.txt").exists()
    elif what == "list-kernels":
        assert out.getvalue().split() == ck.kernel_names
    else:
        assert "89 patterns detected" in err.getvalue()
        assert "test log differed" not in err.getvalue()


def test_state_carried_from_jax_gives_same_pearson(tmp_path):
    """Each example chromosome: a JAX ContactMap after create_mat, carried
    into the port, gives the JAX band engine's (corr, log10p, cand).

    corr is held to the golden score bound (tests/test_golden_outputs.py:65)
    rather than 2e-5: on this detrended map the float32 sums of the JAX
    engine are themselves ~4e-5 from exact, and its own XLA and Pallas
    engines differ by 3.6e-5 here."""
    path = str(tmp_path / "example.cool")
    shutil.copy(ROOT / "data_test" / "example.cool", path)
    cfg = dict(ck.loops)
    kernel = np.asarray(cfg["kernels"][0])
    hg = JaxHicGenome(path, kernel_config=cfg)
    hg.normalize("auto")
    hg.compute_max_dist()
    hg.make_sub_matrices()
    port_cfg = kernel_config_from_jax(cfg)
    for _, sub in hg.sub_mats.iterrows():
        cm = sub.contact_map
        cm.create_mat()
        port_cm = contact_map_from_jax(cm, "cpu")
        got = _band_correlate(port_cm, port_cfg, kernel)
        rows, width = port_cm.band_dev.shape
        ref = [np.asarray(a) for a in jax_band_correlate(cm, cfg, kernel, None)]
        # outside the port's layout the JAX maps hold bucket padding only
        assert not ref[0][rows:].any() and not ref[0][:, width:].any()
        ref = [a[:rows, :width] for a in ref]
        assert_pearson_close(
            ref, got, cm.shape[0], cm.max_dist, cfg["pearson"], corr_tol=5e-5
        )
        assert ref[2].sum() > 0


@pytest.mark.parametrize("mode", ["smooth", "raw", "dump"])
def test_preprocessed_band_matches_jax(tmp_path, mode):
    """Each example chromosome preprocessed by a JAX ContactMap and by the
    port from the npz export give the same band: the staged preprocess
    (isotonic distance law of --smooth-trend; the detrend / remove_diags
    stages of --dump) and the raw-count path of --norm raw.  Values
    within rtol 1e-6 / atol 1e-7 (float32 distance laws summed in
    different orders), the same zeros."""
    path = str(tmp_path / "example.cool")
    shutil.copy(ROOT / "data_test" / "example.cool", path)
    cfg = dict(ck.loops)
    dump = str(tmp_path / "dump") if mode == "dump" else None
    hg = JaxHicGenome(path, kernel_config=cfg, smooth=mode == "smooth", dump=dump)
    hg.normalize("raw" if mode == "raw" else "auto")
    hg.compute_max_dist()
    hg.make_sub_matrices()
    port_dump = str(tmp_path / "port_dump") if mode == "dump" else None
    genome = HicGenome(
        ArraySource.from_npz(EXAMPLE_NPZ), kernel_config=kernel_config_from_jax(cfg),
        dump=port_dump, smooth=mode == "smooth", device=torch.device("cpu"),
    )
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(
        io.StringIO()
    ):
        genome.normalize("raw" if mode == "raw" else "auto")
        genome.make_sub_matrices()
        for (_, sub), port_sub in zip(hg.sub_mats.iterrows(), genome.sub_mats.itertuples()):
            cm, port_cm = sub.contact_map, port_sub.contact_map
            cm.create_mat()
            port_cm.create_mat()
            carried = contact_map_from_jax(cm, "cpu")
            assert (carried.use_norm, carried.smooth) == (mode != "raw", mode == "smooth")
            ref, got = carried.band_dev.numpy(), port_cm.band_dev.numpy()
            assert ref.shape == got.shape
            assert np.array_equal(ref == 0, got == 0)
            assert np.allclose(got, ref, rtol=1e-6, atol=1e-7)
            cm.destroy_mat()
    if mode == "dump":
        names = sorted(p.name for p in (tmp_path / "dump").iterdir())
        assert names == sorted(p.name for p in (tmp_path / "port_dump").iterdir())
        assert len(names) == 6


def _make_synthetic_tool():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_cool", ROOT / "tools" / "make_synthetic_cool.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_genome(path, chroms, bins, seed, binsize=5000):
    """What ``tools/make_synthetic_cool.py --chroms --bins --seed`` writes:
    the balanced cool file at ``path`` and the planted loops."""
    from chromosight_tpu.io.cool import CoolFile, create_cool
    from chromosight_tpu.ops.balance import ice_balance

    tool = _make_synthetic_tool()
    rng = np.random.RandomState(seed)
    bins_l, px_l, planted = [], [], []
    for c in range(chroms):
        rows, cols, vals, loops = tool.synth_chrom(bins, binsize, rng)
        start = np.arange(bins) * binsize
        bins_l.append(
            pd.DataFrame({"chrom": f"chr{c + 1}", "start": start, "end": start + binsize})
        )
        px_l.append(
            pd.DataFrame(
                {"bin1_id": rows + c * bins, "bin2_id": cols + c * bins, "count": vals}
            )
        )
        planted += [(f"chr{c + 1}", i, j) for i, j in loops]
    pixels = pd.concat(px_l, ignore_index=True)
    pixels["count"] = pixels["count"].astype(np.int32)
    create_cool(path, pd.concat(bins_l, ignore_index=True), pixels)
    ice_balance(CoolFile(path), cis_only=True, store=True)
    return CoolFile(path), planted


def test_synthetic_source_matches_generator_tool(tmp_path):
    """Pixels, planted loops and ICE weights of the synthetic source equal
    the generator tool's for the same seed."""
    src = ArraySource.from_synthetic(2, 3000, seed=5)
    clr, planted = _tool_genome(str(tmp_path / "g.cool"), 2, 3000, seed=5)
    b1, b2, ct = (np.concatenate(a) for a in zip(*clr.pixel_chunks()))
    assert np.array_equal(src.bin1, b1)
    assert np.array_equal(src.bin2, b2)
    assert np.array_equal(src.count, ct)
    assert src.planted == planted
    assert src.chromnames == clr.chromnames
    assert src.binsize == clr.binsize == 5000
    assert np.array_equal(src.weights, clr.weights, equal_nan=True)


def test_synthetic_genome_detect_matches_jax(tmp_path):
    """The chip run's genome phase at a CPU size: the port's detect on the
    synthetic source gives the JAX CLI's calls on the same genome written
    by the generator tool, and finds the planted loops."""
    from chromosight_torch.cli.main import detect
    from chromosight_tpu.cli.args import parse_args
    from chromosight_tpu.cli.main import main as jax_main

    src = ArraySource.from_synthetic(1, 700, seed=3)
    cool = str(tmp_path / "g.cool")
    _tool_genome(cool, 1, 700, seed=3)
    prefix = str(tmp_path / "port")
    args = parse_args(["detect", "--no-plotting", "synthetic", prefix], "")
    table, windows = detect(src, args, device="cpu")
    assert jax_main(["detect", "--no-plotting", cool, str(tmp_path / "jax")]) == 0
    ref = pd.read_csv(str(tmp_path / "jax.tsv"), sep="\t")
    ours = pd.read_csv(prefix + ".tsv", sep="\t")
    assert len(ours) == len(ref) == len(table["bin1"]) == windows.shape[0] > 0
    assert (ours.bin1 == ref.bin1).all() and (ours.bin2 == ref.bin2).all()
    assert np.abs(ours.score - ref.score).max() < 5e-5
    assert planted_recall(src, table) == 1.0


def test_imports_without_jax_h5py_pandas_jsonschema(tmp_path):
    """Every module of the package loads with jax, h5py, jsonschema and
    chromosight_tpu blocked (the card's machine has neither h5py nor jax;
    pandas is needed since the Python API returns the JAX package's
    DataFrames), among them ``utils.*``, ``models``, ``io.cool``,
    ``version`` and the benches ``bench.*`` (and
    ``bench_torch.py``); TUTORIAL's Python API block runs on the npz with
    ``device="cpu"``; and detect (a short scan distance keeps the CPU run
    quick), quantify, detect --inter on the dense and on the tiled
    engine, list-kernels and generate-config run from the npz; and, as on
    the card's machine, detect from data_test/example.cool gives the 89
    golden loops, through the count path and through the f32 band (the
    same table and windows), and create_cool and store_weights write
    files that the port (and h5py, here) reads back."""
    prefix = str(tmp_path / "blocked")
    code = f"""
import sys
for name in ("jax", "jaxlib", "h5py", "jsonschema", "chromosight_tpu"):
    sys.modules[name] = None
import importlib, pkgutil
import chromosight_torch, chromosight_torch.cli.main as cli
names = [m.name for m in pkgutil.walk_packages(chromosight_torch.__path__, "chromosight_torch.")]
for name in names:
    importlib.import_module(name)
assert "chromosight_torch.native" in names and "chromosight_torch.ops.balance" in names
assert {{"chromosight_torch.models", "chromosight_torch.io.cool", "chromosight_torch.version",
         "chromosight_torch.utils"}} <= set(names)
# the benches, and bench_torch.py, which imports none of bench.py
assert {{"chromosight_torch.bench." + m for m in ("genome", "baseline", "detect", "quantify",
                                                "inter", "baseline_configs")}} <= set(names)
import runpy
runpy.run_path({str(ROOT / "bench_torch.py")!r}, run_name="bench_torch")
assert "bench" not in sys.modules
for alias in ("detection", "preprocessing", "io", "stats", "plotting", "contacts_map"):
    importlib.import_module("chromosight_torch.utils." + alias)
assert chromosight_torch.__version__ == chromosight_torch.version.__version__

# docs/TUTORIAL.md's Python API block, on the npz export and the CPU
import numpy as np
import chromosight_torch.kernels as ck
import chromosight_torch.utils.detection as cud
import chromosight_torch.utils.preprocessing as cup
from chromosight_torch.runtime import HicGenome
from chromosight_torch.io.source import ArraySource

matrix = ArraySource.from_npz({str(EXAMPLE_NPZ)!r}).pixels_coo((0, 200), (0, 200), balance=True)
import scipy.sparse as sp
matrix = sp.coo_matrix((np.nan_to_num(matrix[2]), matrix[:2]), shape=(200, 200)).toarray()
corr, logp = cud.normxcorr2(matrix, ck.loops["kernels"][0], pval=True, device="cpu")
coords, foci = cud.pick_foci(corr, pearson=0.3)
assert coords is not None and logp.shape == corr.shape

g = HicGenome({str(EXAMPLE_NPZ)!r}, kernel_config=dict(ck.loops), device="cpu")
g.normalize(norm="auto")
g.compute_max_dist()
g.make_sub_matrices()
cm = g.sub_mats.contact_map[0]
cm.create_mat()
patterns, windows = cud.pattern_detector(
    cm, dict(ck.loops, tsvd=None), ck.loops["kernels"][0], full=True
)
assert len(patterns) == len(windows) > 0 and list(patterns.columns) == ["bin1", "bin2", "score", "pvalue"]

argv = ["detect", "--no-plotting", "--max-dist", "60000", {str(EXAMPLE_NPZ)!r}, {prefix!r}]
assert cli.main(argv, device="cpu") == 0
argv = ["quantify", "--no-plotting", {str(ROOT / "data_test" / "example.bed2")!r},
        {str(EXAMPLE_NPZ)!r}, {prefix + "_q"!r}]
assert cli.main(argv, device="cpu") == 0
import chromosight_torch.ops.tiled as tiled
import chromosight_torch.runtime.contact_map as contact_map
for limit, suffix in ((8192, "_inter"), (50, "_tiled")):
    contact_map.DENSE_LIMIT, tiled.DEFAULT_TILE = limit, 128
    argv = ["detect", "--no-plotting", "--inter", "--max-dist", "60000",
            {str(EXAMPLE_NPZ)!r}, {prefix!r} + suffix]
    assert cli.main(argv, device="cpu") == 0
import chromosight_torch.observability as observability
assert observability.counters()["tiles: scanned"] > 0
assert cli.main(["list-kernels", "--long", "--mat"]) == 0
assert cli.main(["generate-config", "--preset", "borders", {prefix + "_cfg"!r}]) == 0

# the card's machine reads .cool files with the port's own HDF5 code:
# detect from data_test/example.cool, then create_cool and store_weights
import shutil
# through the count path (packed raw counts read without bin1_id,
# unpacked and balanced by torch), then through the f32 band
from chromosight_torch import observability
observability.reset()
argv = ["detect", "--no-plotting", {str(EXAMPLE_COOL)!r}, {prefix + "_cool"!r}]
assert cli.main(argv, device="cpu") == 0
modes = [r["mode"] for r in observability.band_uploads().values()]
assert modes == ["u4"] * 3, modes
contact_map.COUNT_PACKING = None
argv = ["detect", "--no-plotting", {str(EXAMPLE_COOL)!r}, {prefix + "_f32"!r}]
assert cli.main(argv, device="cpu") == 0
contact_map.COUNT_PACKING = "u4"
from chromosight_torch.io import CoolFile, create_cool
from chromosight_torch.io.source import CoolSource
clr = CoolFile({str(EXAMPLE_COOL)!r})
pixels = dict(zip(("bin1_id", "bin2_id", "count"), clr._pixels(0, clr.nnz)))
create_cool({prefix + "_new.cool"!r}, clr.bins(), pixels)
shutil.copy({str(EXAMPLE_COOL)!r}, {prefix + "_copy.cool"!r})
for path in ({prefix + "_new.cool"!r}, {prefix + "_copy.cool"!r}):
    CoolSource(path).store_weights(np.arange(720.0), stats={{"mad_max": 5}})
    again = CoolFile(path)
    assert np.array_equal(again.weights, np.arange(720.0)) and again.nnz == clr.nnz
    assert again.info["nnz"] == clr.info["nnz"] and again.chroms().equals(clr.chroms())
assert not any(m == "chromosight_tpu" or m.startswith("chromosight_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
assert sys.modules["jax"] is None and sys.modules["h5py"] is None
"""
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert len(pathlib.Path(prefix + ".tsv").read_text().splitlines()) > 1
    golden = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    from_cool = pd.read_csv(prefix + "_cool.tsv", sep="\t")
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(from_cool) == 89 and from_cool[key].equals(golden[key])
    for ext in (".tsv", ".json"):
        f32_path = pathlib.Path(prefix + "_f32" + ext).read_bytes()
        assert f32_path == pathlib.Path(prefix + "_cool" + ext).read_bytes()
    assert np.abs(from_cool.score - golden.score).max() < 5e-5
    with h5py.File(prefix + "_new.cool", "r") as f:
        assert f["bins/weight"][:].tolist() == list(np.arange(720.0))
    assert len(pathlib.Path(prefix + "_q.tsv").read_text().splitlines()) == 54
    assert len(list(tmp_path.glob("blocked_cfg.*.txt"))) == 3
    assert "loops_small" in res.stdout
    inter = pd.read_csv(prefix + "_inter.tsv", sep="\t")
    tiled = pd.read_csv(prefix + "_tiled.tsv", sep="\t")
    key = ["chrom1", "start1", "chrom2", "start2", "bin1", "bin2", "kernel_id", "iteration"]
    assert inter[key].equals(tiled[key]) and (inter.chrom1 != inter.chrom2).any()
    assert np.abs(inter.score - tiled.score).max() < 5e-5
