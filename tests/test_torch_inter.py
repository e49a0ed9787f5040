"""The port's inter-chromosomal path on CPU, against the JAX package and
the reference goldens: the trans fetch and the synthetic trans contacts,
the trans sub-matrices, the sparse window validation and point queries,
``pattern_detector`` on dense and CSR inter maps carried over from JAX
``ContactMap`` objects, and ``detect --inter`` / ``quantify --inter``
end to end on the dense engine and on the tiled engine (``DENSE_LIMIT``
lowered to 50, as ``CHROMOSIGHT_TPU_DENSE_LIMIT=50`` does for the JAX
package), ``--dump`` included."""

import contextlib
import io
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import chromosight_torch.detection as tdet
import chromosight_torch.observability as obs
import chromosight_torch.ops.tiled as ttiled
import chromosight_torch.runtime.contact_map as tcm
import chromosight_tpu.detection as jdet
import chromosight_tpu.kernels as ck
from chromosight_torch.cli.main import main
from chromosight_torch.io.source import ArraySource
from chromosight_torch.ops.normxcorr import normxcorr2_dense
from chromosight_torch.runtime.genome import HicGenome
from chromosight_torch.state import contact_map_from_jax, kernel_config_from_jax
from chromosight_tpu.cli.main import main as jax_main
from chromosight_tpu.io.cool import CoolFile
from chromosight_tpu.ops.normxcorr import normxcorr2_dense as j_normxcorr2_dense
from chromosight_tpu.ops.tiled import normxcorr2_sparse_tiled as j_tiled
from chromosight_tpu.runtime.genome import HicGenome as JaxHicGenome
from torch_parity import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
EXAMPLE_NPZ = DATA / "example_cool.npz"
KEY = ["bin1", "bin2", "kernel_id", "iteration"]
# tests/test_golden_outputs.py:207-210
PAIRS = (
    "chr1\t63000\t64000\tchr1\t74000\t75000\n"
    "chr1\t50000\t51000\tchr2\t80000\t81000\n"
    "chr1\t100000\t101000\tchr2\t200000\t201000\n"
    "chr2\t130000\t131000\tchr3\t139000\t140000\n"
)


@pytest.fixture(scope="module")
def example_cool(tmp_path_factory):
    path = tmp_path_factory.mktemp("cool") / "example.cool"
    shutil.copy(ROOT / "data_test" / "example.cool", path)
    return str(path)


@pytest.fixture
def tiled_path(monkeypatch):
    """Inter maps above 50 bins a side stay sparse and go to the tiled
    engine, at tile 128, in both packages."""
    monkeypatch.setattr(tcm, "DENSE_LIMIT", 50)
    monkeypatch.setattr(ttiled, "DEFAULT_TILE", 128)
    monkeypatch.setenv("CHROMOSIGHT_TPU_DENSE_LIMIT", "50")
    monkeypatch.setenv("CHROMOSIGHT_TPU_TILE", "128")


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(
        io.StringIO()
    ):
        return fn(*args, **kwargs)


# ------------------------------------------------------------------ #
# Sources and sub-matrices
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("pair", [("chr1", "chr2"), ("chr2", "chr3"), ("chr1", "chr1")])
def test_pixels_coo_matches_cool_reader(example_cool, pair, balance):
    """The trans fetch (and an overlapping intra rectangle, mirrored)
    against the JAX package's cool reader: the native stored-dtype trans
    fetch bit for bit, its generic fetch for intra rectangles."""
    src = ArraySource.from_npz(EXAMPLE_NPZ)
    clr = CoolFile(example_cool)
    e1, e2 = clr.extent(pair[0]), clr.extent(pair[1])
    got = src.trans_coo_raw(e1, e2, balance=balance)
    ref = clr.trans_coo_raw(e1, e2, balance=balance)
    if ref is None:
        assert got is None
        got = src.pixels_coo(e1, e2, balance=balance)
        ref = clr.pixels_coo(e1, e2, balance=balance)
    assert len(got[0]) == len(ref[0]) > 100
    order = np.lexsort((got[1], got[0]))
    order_ref = np.lexsort((ref[1], ref[0]))
    for a, b in zip(got, ref):
        assert np.array_equal(np.asarray(a)[order], np.asarray(b)[order_ref], equal_nan=True)
    assert got[2].dtype == np.asarray(ref[2]).dtype


def test_synthetic_trans_contacts_match_generator_tool(tmp_path):
    """``from_synthetic(..., trans_density)`` draws what
    ``tools/make_synthetic_cool.py --trans-density`` writes: pixels, ICE
    weights and planted loops."""
    path = tmp_path / "g.cool"
    res = subprocess.run(
        [sys.executable, "tools/make_synthetic_cool.py", str(path), "--bins", "1200",
         "--chroms", "3", "--seed", "5", "--trans-density", "0.002"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert res.returncode == 0, res.stderr[-2000:]
    src = ArraySource.from_synthetic(3, 1200, seed=5, trans_density=0.002)
    clr = CoolFile(str(path))
    b1, b2, ct = (np.concatenate(a) for a in zip(*clr.pixel_chunks()))
    assert np.array_equal(src.bin1, b1) and np.array_equal(src.bin2, b2)
    assert np.array_equal(src.count, ct)
    trans = (src.bin1 // 1200) != (src.bin2 // 1200)
    assert 5000 < trans.sum() < 3 * 0.002 * 1200**2
    assert np.array_equal(src.weights, clr.weights, equal_nan=True)
    truth = pd.read_csv(str(path) + ".truth.bed2d", sep="\t", header=None)
    assert [(c, i, j) for c, i, j in src.planted] == [
        (r[0], r[1] // 5000, r[4] // 5000) for r in truth.itertuples(index=False)
    ]


def test_trans_sub_matrices_match_jax(example_cool):
    """With ``inter`` the genome holds every pair chr1 <= chr2 in the JAX
    package's order, trans maps without a scan distance."""
    cfg = dict(ck.loops)
    hg = JaxHicGenome(example_cool, kernel_config=cfg, inter=True)
    quiet(hg.normalize, "auto")
    hg.compute_max_dist()
    quiet(hg.make_sub_matrices)
    genome = HicGenome(
        ArraySource.from_npz(EXAMPLE_NPZ), inter=True, kernel_config=kernel_config_from_jax(cfg),
        device=torch.device("cpu"),
    )
    quiet(genome.normalize, "auto")
    quiet(genome.make_sub_matrices)
    ref = [(r.chr1, r.chr2, r.contact_map) for _, r in hg.sub_mats.iterrows()]
    assert len(ref) == len(genome.sub_mats) == 6
    for (c1, c2, jcm), sub in zip(ref, genome.sub_mats.itertuples()):
        cm = sub.contact_map
        assert (sub.chr1, sub.chr2, cm.name, cm.inter) == (c1, c2, jcm.name, jcm.inter)
        assert cm.extent == [tuple(e) for e in jcm.extent]
        assert cm.max_dist == jcm.max_dist and cm.is_banded == jcm.is_banded
        for a, b in zip(cm.detectable_bins, jcm.detectable_bins):
            assert np.array_equal(a, b)
        if cm.inter:
            table = {"bin1": np.array([3]), "bin2": np.array([5])}
            full = genome.get_full_mat_pattern(c1, c2, table)
            assert (full["bin1"][0], full["bin2"][0]) == (3 + cm.extent[0][0], 5 + cm.extent[1][0])


# ------------------------------------------------------------------ #
# Sparse validation and point queries (tests/test_detection.py:392-553)
# ------------------------------------------------------------------ #
def _assert_table(ref, got, windows_ref, windows_got):
    ref = ref.reset_index(drop=True)
    assert np.array_equal(ref.bin1.to_numpy(), got["bin1"])
    assert np.array_equal(ref.bin2.to_numpy(), got["bin2"])
    assert np.array_equal(ref.score.to_numpy(), got["score"], equal_nan=True)
    assert np.array_equal(windows_ref, windows_got, equal_nan=True)


@pytest.mark.parametrize("n_pat", [40, 300])
@pytest.mark.parametrize("pad", [None, (4, 4)])
@pytest.mark.parametrize("drop", [True, False])
def test_validate_patterns_sparse_matches_jax(drop, pad, n_pat):
    """Both phases (the value-free pre-filter runs above 64 patterns) and
    the virtual padding: the same windows, scores and validity."""
    rng = np.random.RandomState(21)
    n1, n2 = 140, 120
    mat = rng.rand(n1, n2) * (rng.rand(n1, n2) < 0.9)
    conv = rng.rand(n1, n2) * (rng.rand(n1, n2) < 0.5)
    kernel = rng.rand(9, 9)
    det = (np.flatnonzero(rng.rand(n1) > 0.1), np.flatnonzero(rng.rand(n2) > 0.1))
    coords = np.stack([rng.randint(0, n1, n_pat), rng.randint(0, n2, n_pat)], axis=1)
    if pad is not None:
        coords = coords + pad
        det = (det[0] + pad[0], det[1] + pad[1])
    args = (coords, sp.csr_matrix(mat), sp.csr_matrix(conv), det, kernel)
    kw = dict(drop=drop, zero_tol=0.3, missing_tol=0.5, pad=pad)
    ref = jdet._validate_patterns_sparse(*args, **kw)
    got = tdet._validate_patterns_sparse(*args, **kw)
    _assert_table(ref[0], got[0], ref[1], got[1])
    assert np.isfinite(got[0]["score"]).sum() > 5


def test_validate_patterns_sparse_nan_band_matches_jax():
    rng = np.random.RandomState(22)
    n = 100
    mat = rng.rand(n, n) * (rng.rand(n, n) < 0.6)
    conv = rng.rand(n, n) * (rng.rand(n, n) < 0.1)
    kernel = rng.rand(7, 7)
    det = (np.arange(n), np.arange(n))
    coords = np.stack([rng.randint(10, n - 10, 80), rng.randint(10, n - 10, 80)], axis=1)
    args = (coords, sp.csr_matrix(mat), sp.csr_matrix(conv), det, kernel)
    for drop in (True, False):
        ref = jdet._validate_patterns_sparse(*args, drop=drop, nan_band=7)
        got = tdet._validate_patterns_sparse(*args, drop=drop, nan_band=7)
        _assert_table(ref[0], got[0], ref[1], got[1])


def test_validate_patterns_dense_matches_jax():
    rng = np.random.RandomState(23)
    mat = rng.rand(120, 130) * (rng.rand(120, 130) < 0.7)
    conv = rng.rand(120, 130)
    kernel = rng.rand(9, 9)
    det = (np.flatnonzero(rng.rand(120) > 0.1), np.flatnonzero(rng.rand(130) > 0.1))
    coords = np.stack([rng.randint(0, 120, 60), rng.randint(0, 130, 60)], axis=1)
    for drop in (True, False):
        ref = jdet.validate_patterns(coords, mat, conv, det, kernel, drop=drop)
        got = tdet.validate_patterns(coords, mat, conv, det, kernel, drop=drop)
        _assert_table(ref[0], got[0], ref[1], got[1])


@pytest.mark.parametrize("segmented", [False, True])
def test_csr_point_values_matches_jax(segmented, monkeypatch):
    rng = np.random.RandomState(11)
    mat = sp.random(300, 250, density=0.05, random_state=rng, format="csr")
    qr = rng.randint(-5, 305, 2000)
    qc = rng.randint(-5, 255, 2000)
    if segmented:
        monkeypatch.setattr(tdet, "POINT_QUERY_FLAT_NNZ", 0)
        monkeypatch.setattr(jdet, "_POINT_QUERY_FLAT_NNZ", 0)
    got = tdet._csr_point_values(mat, qr, qc)
    assert np.array_equal(got, jdet._csr_point_values(mat, qr, qc))
    assert (got != 0).sum() > 50


def test_foci_match_jax():
    """pick_foci on a dense array and on a CSR matrix, and the label /
    filter pair, against the JAX package's."""
    rng = np.random.RandomState(12)
    conv = rng.rand(80, 90) * (rng.rand(80, 90) < 0.3)
    for mat in (conv, sp.csr_matrix(conv)):
        ref, got = jdet.pick_foci(mat, 0.4), tdet.pick_foci(mat, 0.4)
        assert np.array_equal(ref[0], got[0])
        assert np.array_equal(ref[1].toarray(), got[1].toarray())
    n_ref, lab_ref = jdet.label_foci(sp.csr_matrix(conv))
    n_got, lab_got = tdet.label_foci(sp.csr_matrix(conv))
    assert n_ref == n_got and np.array_equal(lab_ref.toarray(), lab_got.toarray())
    ref = jdet.filter_foci(lab_ref, 3)
    got = tdet.filter_foci(lab_got, 3)
    assert ref[0] == got[0] and np.array_equal(ref[1].toarray(), got[1].toarray())


# ------------------------------------------------------------------ #
# Inter maps carried over from the JAX package
# ------------------------------------------------------------------ #
def _jax_inter_maps(example_cool):
    cfg = dict(ck.loops)
    hg = JaxHicGenome(example_cool, kernel_config=cfg, inter=True)
    quiet(hg.normalize, "auto")
    hg.compute_max_dist()
    quiet(hg.make_sub_matrices)
    return cfg, [r.contact_map for _, r in hg.sub_mats.iterrows() if r.contact_map.inter]


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_carried_inter_map_gives_jax_pearson(example_cool, form, request):
    """A JAX inter map after create_mat (dense, or CSR on the tiled path),
    carried into the port: the port's engine gives the JAX engine's
    Pearson on it, within the golden score bound 5e-5
    (tests/test_golden_outputs.py:65): the JAX engine's float32 window sums
    are themselves a few 1e-5 from exact on these maps, the port's float64
    ones are not."""
    if form == "sparse":
        request.getfixturevalue("tiled_path")
    cfg, maps = _jax_inter_maps(example_cool)
    kernel = np.asarray(cfg["kernels"][0])
    for cm in maps:
        quiet(cm.create_mat)
        port = contact_map_from_jax(cm, "cpu")
        assert port.inter and (port.sparse is not None) == (form == "sparse")
        n1, n2 = port.shape
        miss = [~np.isin(np.arange(n), d) for n, d in zip((n1, n2), port.detectable_bins)]
        args = dict(full=True, pval=True, missing_tol=0.5)
        if form == "dense":
            mask = miss[0][:, None] | miss[1][None, :]
            ref = j_normxcorr2_dense(cm.dense, kernel, missing_mask=mask, **args)
            got = normxcorr2_dense(port.dense_dev, kernel, missing_mask=torch.from_numpy(mask), **args)
            ref, got = np.asarray(ref[0]), got[0].numpy()
        else:
            ref = j_tiled(cm.sparse, kernel, missing_vectors=miss, **args)[0].toarray()
            got = ttiled.normxcorr2_sparse_tiled(
                port.sparse, kernel, missing_vectors=miss, device="cpu", **args
            )[0].toarray()
            assert np.array_equal(ref != 0, got != 0)
        assert (ref != 0).sum() > 1000
        assert np.abs(ref - got).max() < 5e-5
        cm.destroy_mat()


@pytest.mark.parametrize("mode", ["detect", "quantify"])
@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_pattern_detector_on_carried_inter_maps(example_cool, form, mode, request):
    """``pattern_detector`` on each carried inter map makes the JAX
    detector's calls (quantify: scores the same pixels, NaN included),
    score within 5e-5, p-values within 0.1% (the mid-range p-values of
    quantified pixels move with the float32 rounding of corr), the same
    windows."""
    if form == "sparse":
        request.getfixturevalue("tiled_path")
    cfg, maps = _jax_inter_maps(example_cool)
    cfg["pearson"] = 0.1  # enough trans calls on this small map
    cfg["max_perc_zero"] = 95.0
    port_cfg = kernel_config_from_jax(cfg)
    kernel = np.asarray(cfg["kernels"][0])
    rng = np.random.RandomState(3)
    found = 0
    for cm in maps:
        quiet(cm.create_mat)
        port = contact_map_from_jax(cm, "cpu")
        coords = None
        if mode == "quantify":
            coords = np.stack(
                [rng.randint(0, port.shape[0], 40), rng.randint(0, port.shape[1], 40)], 1
            )
        ref = jdet.pattern_detector(cm, cfg, kernel, coords=coords, full=True)
        got = tdet.pattern_detector(port, port_cfg, kernel, coords=coords, full=True)
        cm.destroy_mat()
        if ref[0] is None:
            assert got[0] is None
            continue
        r = ref[0].reset_index(drop=True)
        assert np.array_equal(r.bin1.to_numpy(), got[0]["bin1"])
        assert np.array_equal(r.bin2.to_numpy(), got[0]["bin2"])
        for col in ("score", "pvalue"):
            a, b = r[col].to_numpy(), got[0][col]
            assert np.array_equal(np.isnan(a), np.isnan(b))
            ok = ~np.isnan(a)
            found += int(ok.sum())
            if col == "score" and ok.any():
                assert np.abs(a[ok] - b[ok]).max() < 5e-5
            assert np.allclose(a[ok], b[ok], rtol=1e-3, atol=1e-8)
        assert np.array_equal(ref[1], got[1], equal_nan=True)
    assert found > 0


# ------------------------------------------------------------------ #
# The CLI end to end
# ------------------------------------------------------------------ #
def _run_detect(prefix, *flags):
    rc = quiet(
        main, ["detect", "--no-plotting", "--inter", *flags, str(EXAMPLE_NPZ), prefix],
        device="cpu",
    )
    assert rc == 0
    return pd.read_csv(prefix + ".tsv", sep="\t")


@pytest.mark.parametrize("path", ["dense", "tiled"])
def test_detect_inter_reproduces_golden(tmp_path, path, request):
    """``detect --inter`` reproduces golden_detect_loops_inter.tsv on the
    dense engine and on the tiled engine: identical (bin1, bin2,
    kernel_id, iteration), score |d| < 5e-5, p-value |d| < 1e-5
    (tests/test_golden_outputs.py:192-196)."""
    if path == "tiled":
        request.getfixturevalue("tiled_path")
    before = obs.counters().get("tiles: scanned", 0)
    ours = _run_detect(str(tmp_path / "out"))
    scanned = obs.counters().get("tiles: scanned", 0) - before
    assert (scanned > 0) == (path == "tiled")
    golden = pd.read_csv(DATA / "golden_detect_loops_inter.tsv", sep="\t")
    assert len(ours) == len(golden)
    assert set(map(tuple, ours[KEY].values)) == set(map(tuple, golden[KEY].values))
    assert (ours.chrom1 != ours.chrom2).sum() > 0
    m = golden.merge(ours, on=KEY, suffixes=("_ref", "_port"))
    assert np.abs(m.score_ref - m.score_port).max() < 5e-5
    assert np.abs(m.pvalue_ref - m.pvalue_port).max() < 1e-5


QUANTIFY_FLAGS = {"default": [], "lifted": ["--perc-zero", "100", "--perc-undetected", "100"]}


@pytest.fixture(scope="module")
def jax_quantify(tmp_path_factory, example_cool):
    """The JAX CLI's ``quantify --inter`` tables of the four pairs, by
    flag set, and the bed2d file."""
    out = tmp_path_factory.mktemp("jax_quantify")
    bed = out / "pairs.bed2"
    bed.write_text(PAIRS)
    tables = {}
    for name, flags in QUANTIFY_FLAGS.items():
        argv = ["quantify", "--no-plotting", "--inter", *flags, str(bed), example_cool]
        assert quiet(jax_main, [*argv, str(out / name)]) in (0, None)
        tables[name] = pd.read_csv(out / f"{name}.tsv", sep="\t")
    return tables, bed


@pytest.mark.parametrize("flags", list(QUANTIFY_FLAGS))
@pytest.mark.parametrize("path", ["dense", "tiled"])
def test_quantify_inter_matches_jax_cli(tmp_path, jax_quantify, path, flags, request):
    """``quantify --inter`` of the golden test's four pairs gives the JAX
    CLI's table row for row, NaN pattern included, on both engines; with
    the validation limits lifted the trans pairs get scores too."""
    if path == "tiled":
        request.getfixturevalue("tiled_path")
    tables, bed = jax_quantify
    argv = ["quantify", "--no-plotting", "--inter", *QUANTIFY_FLAGS[flags], str(bed)]
    assert quiet(main, [*argv, str(EXAMPLE_NPZ), str(tmp_path / "port")], device="cpu") == 0
    ref = tables[flags]
    ours = pd.read_csv(tmp_path / "port.tsv", sep="\t")
    assert list(ours.columns) == list(ref.columns) and len(ours) == len(ref) == 4
    for col in ("chrom1", "start1", "end1", "chrom2", "start2", "end2", "bin1", "bin2"):
        assert (ours[col] == ref[col]).all(), col
    for col in ("score", "pvalue", "qvalue"):
        a, b = ref[col].to_numpy(), ours[col].to_numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b)), col
        ok = ~np.isnan(a)
        if col == "score":
            assert np.abs(a[ok] - b[ok]).max() < 5e-5
        # mid-range p-values of weak trans windows: within 0.1%
        assert np.allclose(a[ok], b[ok], rtol=1e-3, atol=1e-8), col
    n_scored = int((~np.isnan(ours.score)).sum())
    assert n_scored == (4 if flags == "lifted" else 1)


DUMP_FLAGS = ["--iterations", "1", "--dump"]


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory, example_cool):
    """The snapshot directory of the JAX CLI's ``detect --inter --dump``."""
    out = tmp_path_factory.mktemp("jax_dump")
    rc = quiet(
        jax_main,
        ["detect", "--no-plotting", "--inter", *DUMP_FLAGS, str(out / "dump"),
         example_cool, str(out / "jax")],
    )
    assert rc in (0, None)
    return out / "dump"


@pytest.mark.parametrize("path", ["dense", "tiled"])
def test_detect_inter_dump_matches_jax(tmp_path, jax_dump, path, request):
    """``detect --inter --dump DIR`` writes the JAX CLI's snapshots, on
    both engines: the band stages of the intra maps, ``01_process_inter``,
    ``03_normxcorr2`` (the whole map: no candidate-only output with
    ``--dump``) and ``05_foci`` of the trans maps, with the same values."""
    if path == "tiled":
        request.getfixturevalue("tiled_path")
    _run_detect(str(tmp_path / "port"), *DUMP_FLAGS, str(tmp_path / "port_dump"))
    names = sorted(p.name for p in jax_dump.glob("*.npz"))
    assert sorted(p.name for p in (tmp_path / "port_dump").glob("*.npz")) == names
    trans = [n for n in names if n.split("_")[0].split("-")[0] != n.split("_")[0].split("-")[1]]
    assert {n.split("_", 1)[1] for n in trans} == {
        "01_process_inter.npz", "03_normxcorr2.npz", "05_foci.npz"
    }
    for name in trans:
        ref = sp.load_npz(jax_dump / name).toarray()
        ours = sp.load_npz(tmp_path / "port_dump" / name).toarray()
        assert ours.shape == ref.shape, name
        if "_05_foci" in name:
            assert np.array_equal(ours, ref), name
        elif "_01_" in name:
            assert np.allclose(ours, ref, rtol=1e-6, atol=0), name
        else:  # corr, within the golden score bound
            assert np.abs(ours - ref).max() < 5e-5, name


def test_no_trans_map_without_inter(tmp_path):
    """Without --inter only the intra maps are scanned, and quantify warns
    about the trans pairs and leaves them NaN."""
    bed = tmp_path / "pairs.bed2"
    bed.write_text(PAIRS)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(["quantify", "--no-plotting", str(bed), str(EXAMPLE_NPZ),
                   str(tmp_path / "q")], device="cpu")
    assert rc == 0 and "will not be scanned unless --inter" in err.getvalue()
    q = pd.read_csv(tmp_path / "q.tsv", sep="\t")
    assert np.isnan(q.score[q.chrom1 != q.chrom2]).all()
