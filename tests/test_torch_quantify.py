"""The port's quantify on CPU: the patch-matmul Pearson at given pixels
against chromosight_tpu.ops.band.band_normxcorr_at_packed and against the
port's own sweep, the pandas-free bed2d loader against the JAX package's,
and the CLI against the reference goldens and the JAX CLI."""

import contextlib
import io
import json
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from chromosight_torch.cli.main import main
from chromosight_torch.detection import _band_correlate, quantify_banded
from chromosight_torch.io.bed2d import read_bed2d
from chromosight_torch.io.source import ArraySource
from chromosight_torch.ops.band import band_normxcorr_at_packed
from chromosight_torch.runtime.genome import HicGenome
from chromosight_tpu.io.bed2d import load_bed2d as jax_load_bed2d
from chromosight_tpu.ops.band import band_normxcorr_at_packed as jax_at_packed
from chromosight_tpu.ops.band import shear_kernel
from torch_parity import (
    KERNELS,
    MISSING_TOL,
    PRESETS,
    band_case,
    preset_kernel,
    torch_one_thread,  # noqa: F401
)

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
BED2 = ROOT / "data_test" / "example.bed2"
EXAMPLE_NPZ = DATA / "example_cool.npz"


def _at_case(name):
    """(kernels (K, mk, nk), band, missing, n, max_dist)."""
    if name == "borders":
        with open(PRESETS / "borders.json") as handle:
            kernels = np.asarray(json.load(handle)["kernels"], np.float64)
        layout = "sparse"
    elif name == "rect5x9_x3":
        rng = np.random.RandomState(3)
        kernels = rng.rand(3, 5, 9) + 0.1
        layout = "dense"
    else:
        kernels = KERNELS[name]()[None].astype(np.float64)
        layout = "sparse"
    band, miss, n, max_dist = band_case(kernels[0], layout)
    return kernels, band, miss, n, max_dist


@pytest.mark.parametrize("name", ["loops", "borders", "rect5x9_x3"])
def test_band_normxcorr_at_packed_matches_jax(name):
    """Random pixels, in and out of the band and the matrix: scores
    within 2e-5, log10-p within 2e-3 where JAX's is finite and of the same
    finiteness, raw windows exact."""
    kernels, band, miss, n, max_dist = _at_case(name)
    n_k, mk, nk = kernels.shape
    rng = np.random.RandomState(5)
    t = 96
    rows = rng.randint(-4, band.shape[0] + 4, t).astype(np.int32)
    diags = rng.randint(-3, band.shape[1] + 6, t).astype(np.int32)
    ref = np.asarray(
        jax_at_packed(
            jnp.asarray(band),
            jnp.asarray(miss),
            jnp.asarray(rows),
            jnp.asarray(diags),
            jnp.asarray(kernels, jnp.float32),
            jnp.asarray(np.stack([shear_kernel(k) for k in kernels]), jnp.float32),
            jnp.asarray(np.stack([shear_kernel(k**2) for k in kernels]), jnp.float32),
            (mk, nk),
            n,
            max_dist,
            MISSING_TOL,
        )
    )
    got = band_normxcorr_at_packed(
        torch.from_numpy(band),
        torch.from_numpy(miss),
        torch.from_numpy(rows).long(),
        torch.from_numpy(diags).long(),
        kernels,
        n,
        max_dist,
        MISSING_TOL,
    ).numpy()
    assert got.shape == ref.shape == (t, 2 * n_k + mk * nk)
    assert np.abs(got[:, :n_k] - ref[:, :n_k]).max() < 2e-5
    a, b = ref[:, n_k : 2 * n_k], got[:, n_k : 2 * n_k]
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    both = np.isfinite(a)
    assert np.abs(a[both] - b[both]).max() < 2e-3
    assert np.array_equal(got[:, 2 * n_k :], ref[:, 2 * n_k :])
    assert np.abs(ref[:, :n_k]).max() > 0.05


def test_quantify_at_pixels_matches_the_sweep():
    """On each chromosome of the example map, the scores of
    ``quantify_banded`` at every 7th band pixel equal the plain sweep's
    corr there within 1e-6: both sum the window in float64."""
    src = ArraySource.from_npz(EXAMPLE_NPZ)
    cfg = {
        "name": "loops", "kernels": [preset_kernel("loops").astype(np.float64)],
        "max_dist": 100000, "max_perc_undetected": 50.0, "max_perc_zero": 10.0,
        "pearson": 0.3,
    }
    genome = HicGenome(src, kernel_config=cfg, device=torch.device("cpu"))
    genome.normalize("auto")
    genome.make_sub_matrices()
    for cm in genome.sub_mats.contact_map:
        cm.create_mat()
        corr = _band_correlate(cm, cfg, cfg["kernels"][0])[0].numpy()
        i, d = np.nonzero(np.ones_like(corr, dtype=bool))
        pick = slice(0, None, 7)
        coords = np.stack([i[pick], i[pick] + d[pick]], axis=1)
        table, _ = quantify_banded(cm, cfg, cfg["kernels"], coords)[0]
        ok = ~np.isnan(table["score"])
        assert ok.sum() > 100
        assert np.abs(table["score"][ok] - corr[i[pick], d[pick]][ok]).max() < 1e-6
        cm.destroy_mat()


def _bed2d_cases(tmp_path):
    headerless = tmp_path / "noheader.bed2"
    headerless.write_text(
        "chr1\t63000\t64000\tchr1\t74000\t75000\n"
        "chr2\t240000\t241000\tchr2\t130000\t131000\n"
        "chr1\t50000\t51000\tchr2\t80000\t81000\n"
    )
    return [BED2, headerless]


def test_load_bed2d_matches_jax(tmp_path):
    """Columns, types, the header sniffing and the anchor swap of
    intra-chromosomal pairs, on data_test/example.bed2 and a headerless
    file."""
    for path in _bed2d_cases(tmp_path):
        ref = jax_load_bed2d(str(path))
        got = read_bed2d(path)
        assert list(got) == list(ref.columns)
        for col in ref.columns:
            assert np.array_equal(got[col], ref[col].to_numpy()), (path, col)
            assert got[col].dtype.kind == ref[col].to_numpy().astype(
                str if col.startswith("chrom") else np.int64
            ).dtype.kind


def _quantify(tmp_path, flags, name):
    prefix = str(tmp_path / name)
    with contextlib.redirect_stderr(io.StringIO()):
        rc = main(
            ["quantify", "--no-plotting", *flags, str(BED2), str(EXAMPLE_NPZ), prefix],
            device="cpu",
        )
    assert rc == 0
    return prefix


@pytest.mark.parametrize(
    "golden,flags,pvalue_tol",
    [
        ("golden_quantify_loops", [], 1e-6),
        ("golden_quantify_borders", ["--pattern", "borders"], 5e-5),
    ],
)
def test_quantify_matches_reference(tmp_path, golden, flags, pvalue_tol):
    """tests/test_golden_outputs.py:124-173: the same rows by (bin1,
    bin2), the same validation outcome (NaN score), scores within 5e-5,
    p-values within the golden's bound, every q-value NaN."""
    g = pd.read_csv(DATA / f"{golden}.tsv", sep="\t")
    ours = pd.read_csv(_quantify(tmp_path, flags, "q") + ".tsv", sep="\t")
    assert len(ours) == len(g) == 53
    m = g.merge(ours, on=["bin1", "bin2"], suffixes=("_ref", "_port"))
    assert len(m) == 53
    assert (m.score_ref.isna() == m.score_port.isna()).all()
    ok = m.score_ref.notna()
    assert np.abs(m.score_ref[ok] - m.score_port[ok]).max() < 5e-5
    assert (m.pvalue_ref.isna() == m.pvalue_port.isna()).all()
    okp = m.pvalue_ref.notna()
    assert np.abs(m.pvalue_ref[okp] - m.pvalue_port[okp]).max() < pvalue_tol
    assert ours.qvalue.isna().all()


def test_quantify_table_matches_jax_cli(tmp_path):
    """Row order, coordinates, bins (float, NaN outside the map) and the
    NaN pattern of the port's TSV equal the JAX CLI's; scores within
    2e-5 and the window stacks in the same order."""
    from chromosight_tpu.cli.main import main as jax_main

    cool = tmp_path / "example.cool"
    shutil.copy(ROOT / "data_test" / "example.cool", cool)
    ref_prefix = str(tmp_path / "jax")
    with contextlib.redirect_stderr(io.StringIO()):
        assert jax_main(["quantify", "--no-plotting", str(BED2), str(cool), ref_prefix]) in (
            0,
            None,
        )
    prefix = _quantify(tmp_path, ["--win-fmt", "npy"], "port")
    ref = pd.read_csv(ref_prefix + ".tsv", sep="\t")
    ours = pd.read_csv(prefix + ".tsv", sep="\t")
    assert list(ours.columns) == list(ref.columns)
    for col in ["chrom1", "start1", "end1", "chrom2", "start2", "end2", "bin1", "bin2"]:
        assert ours[col].fillna(-1).equals(ref[col].fillna(-1)), col
    for col in ["score", "pvalue", "qvalue"]:
        assert (ours[col].isna() == ref[col].isna()).all(), col
    assert np.nanmax(np.abs(ours.score - ref.score)) < 2e-5
    with open(ref_prefix + ".json") as handle:
        ref_wins = json.load(handle)
    ref_wins = np.array([ref_wins[str(i)] for i in range(len(ref_wins))], np.float64)
    wins = np.load(prefix + ".npy")
    assert wins.shape == ref_wins.shape == (len(ours), 17, 17)
    assert np.array_equal(np.isnan(wins), np.isnan(ref_wins))
    assert np.allclose(wins, ref_wins, rtol=1e-5, atol=1e-6, equal_nan=True)


def test_best_of_kernels_matches_jax():
    """The best score per (chrom1, start1, chrom2, start2) over the
    kernels, with NaN scores sorting last and so winning their pair, a
    repeated pair collapsing to one row, and the output in score order,
    as the JAX package's pandas version gives them."""
    from chromosight_torch.cli.main import _best_of_kernels
    from chromosight_tpu.cli.main import _best_of_kernels as jax_best

    bed2d = {
        "chrom1": np.array(["chr1", "chr1", "chr2", "chr1", "chr2"]),
        "start1": np.array([10, 20, 30, 10, 40], np.int64),
        "end1": np.array([11, 21, 31, 12, 41], np.int64),
        "chrom2": np.array(["chr1", "chr1", "chr2", "chr1", "chr2"]),
        "start2": np.array([50, 60, 70, 50, 80], np.int64),
        "end2": np.array([51, 61, 71, 52, 81], np.int64),
    }
    scores = [
        np.array([0.2, np.nan, 0.7, 0.1, 0.3]),
        np.array([0.4, 0.5, np.nan, 0.6, 0.35]),
        np.array([0.3, 0.45, 0.9, 0.05, 0.25]),
    ]
    pvalues = [s / 10 for s in scores]
    windows = [np.full((5, 3, 3), k, dtype=np.float64) + np.arange(5)[:, None, None] / 10
               for k in range(3)]
    tables = []
    for s, p in zip(scores, pvalues):
        t = pd.DataFrame(bed2d)
        t["score"], t["pvalue"] = s, p
        tables.append(t)
    ref, ref_wins = jax_best(tables, windows)
    got, wins = _best_of_kernels(bed2d, scores, pvalues, windows)
    assert len(got["score"]) == len(ref) == 4
    for col in ref.columns:
        a, b = got[col], ref[col].to_numpy()
        if col in ("score", "pvalue"):
            assert np.array_equal(a, b, equal_nan=True), col
        else:
            assert np.array_equal(a, b), col
    assert np.array_equal(wins, ref_wins)


def test_quantify_through_the_sweep_matches_quantify_at(tmp_path):
    """With --dump set, quantify takes the sweep and the quantify tail
    of ``_band_tail`` (drop=False), as in the JAX package: the same
    scores within 1e-6, p-values, NaN rows and windows as the
    patch-matmul path at the same coordinates."""
    from chromosight_torch.detection import pattern_detector

    src = ArraySource.from_npz(EXAMPLE_NPZ)
    kernel = preset_kernel("loops").astype(np.float64)
    cfg = {
        "name": "loops", "kernels": [kernel], "max_dist": 200000,
        "max_perc_undetected": 50.0, "max_perc_zero": 10.0, "pearson": 0.3,
    }
    genome = HicGenome(src, kernel_config=cfg, device=torch.device("cpu"))
    genome.normalize("auto")
    genome.make_sub_matrices()
    cm = genome.sub_mats.contact_map[0]
    with contextlib.redirect_stdout(io.StringIO()):
        cm.create_mat()
    rng = np.random.RandomState(2)
    i = rng.randint(0, cm.shape[0], 60)
    coords = np.stack([i, i + rng.randint(0, 220, 60)], axis=1)
    at_table, at_wins = pattern_detector(cm, cfg, kernel, coords=coords, full=True)
    sweep_table, sweep_wins = pattern_detector(
        cm, cfg, kernel, coords=coords, dump=tmp_path, full=True
    )
    assert (tmp_path / "chr1-chr1_04_diag_trim.npz").exists()
    for table in (at_table, sweep_table):
        assert len(table["score"]) == 60
    a, b = at_table["score"].to_numpy(), sweep_table["score"].to_numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b)) and np.isnan(a).any()
    ok = ~np.isnan(a)
    assert np.abs(a[ok] - b[ok]).max() < 1e-6
    assert np.allclose(at_table["pvalue"], sweep_table["pvalue"], rtol=1e-4, equal_nan=True)
    assert np.array_equal(at_wins, sweep_wins, equal_nan=True)
