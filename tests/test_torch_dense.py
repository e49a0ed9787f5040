"""The port's dense engine against the JAX package's, on CPU: the dense
Pearson (``normxcorr2_dense``) in every mode, the crossing Pearson of the
tiled engine, ``xcorr2``, the dense missing masks, the dense
preprocessing ops, and ``pattern_detector`` on dense maps, from the same
seeded numpy inputs."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chromosight_tpu.detection as jdet
import chromosight_tpu.ops.normxcorr as jnx
import chromosight_tpu.ops.preprocess as jpre
import chromosight_torch.detection as tdet
import chromosight_torch.ops.normxcorr as tnx
import chromosight_torch.ops.preprocess as tpre
from chromosight_torch.runtime.contact_map import ContactMap
from torch_parity import KERNELS, torch_one_thread  # noqa: F401

SHAPES = ["loops_small", "loops", "rect5x9"]


def dense_case(seed=0, shape=(120, 100), density=0.3, sym_upper=False):
    """(signal f64, missing mask bool, missing rows, missing cols): a
    random map with missing rows and columns zeroed, upper triangular
    when ``sym_upper``."""
    rng = np.random.RandomState(seed)
    if sym_upper:
        shape = (shape[0], shape[0])
    mat = rng.rand(*shape) * 3 * (rng.rand(*shape) < density)
    miss_r = rng.rand(shape[0]) < 0.06
    miss_c = miss_r if sym_upper else rng.rand(shape[1]) < 0.06
    if sym_upper:
        mat = np.triu(mat)
    mask = miss_r[:, None] | miss_c[None, :]
    mat[mask] = 0
    return mat, mask, miss_r, miss_c


def assert_corr_logp(ref, got, corr_tol=2e-5):
    corr_r, logp_r = (None if a is None else np.asarray(a, dtype=np.float64) for a in ref)
    corr_g, logp_g = (None if a is None else a.double().numpy() for a in got)
    assert corr_r.shape == corr_g.shape
    assert np.abs(corr_r - corr_g).max() < corr_tol
    if logp_r is None:
        assert logp_g is None
        return
    assert np.array_equal(np.isfinite(logp_r), np.isfinite(logp_g))
    both = np.isfinite(logp_r)
    assert np.abs(logp_r[both] - logp_g[both]).max() < 2e-3


@pytest.mark.parametrize("kname", SHAPES)
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("sym_upper", [False, True])
def test_normxcorr2_dense_matches_jax(kname, full, with_mask, sym_upper):
    kernel = KERNELS[kname]()
    mat, mask, _, _ = dense_case(sym_upper=sym_upper)
    args = dict(full=full, sym_upper=sym_upper, pval=True, missing_tol=0.5)
    ref = jnx.normxcorr2_dense(mat, kernel, missing_mask=mask if with_mask else None, **args)
    got = tnx.normxcorr2_dense(
        torch.from_numpy(mat), kernel,
        missing_mask=torch.from_numpy(mask) if with_mask else None, **args,
    )
    assert_corr_logp(ref, got)
    assert (np.asarray(ref[0]) != 0).sum() > 100


@pytest.mark.parametrize("kname", SHAPES)
@pytest.mark.parametrize("max_dist", [None, 30])
def test_normxcorr2_dense_tsvd_and_banded_frame_match_jax(kname, max_dist):
    """--tsvd factors, and the banded frame rules of upper-symmetric maps
    with a scan distance."""
    kernel = KERNELS[kname]()
    mat, mask, _, _ = dense_case(seed=3, sym_upper=True)
    args = dict(full=True, sym_upper=True, pval=True, max_dist=max_dist, tsvd=0.999)
    ref = jnx.normxcorr2_dense(mat, kernel, missing_mask=mask, **args)
    got = tnx.normxcorr2_dense(
        torch.from_numpy(mat), kernel, missing_mask=torch.from_numpy(mask), **args
    )
    assert_corr_logp(ref, got)


def test_normxcorr2_dense_refusals():
    mat, mask, _, _ = dense_case()
    sig = torch.from_numpy(mat)
    with pytest.raises(ValueError, match="flat"):
        tnx.normxcorr2_dense(sig, np.ones((3, 3)))
    with pytest.raises(ValueError, match="bool"):
        tnx.normxcorr2_dense(sig, KERNELS["loops"](), missing_mask=sig)
    with pytest.raises(ValueError, match="same shape"):
        tnx.normxcorr2_dense(sig, KERNELS["loops"](), missing_mask=torch.from_numpy(mask[1:]))


@pytest.mark.parametrize("kname", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_crossing_pearson_matches_jax(kname, seed):
    """normxcorr_crossing_valid on a framed block whose missing mask is a
    crossing: corr within 2e-5 of the JAX function, and of the port's own
    full-mask Pearson on the same block, with the same non-zero pixels
    (the rank-collapsed mask sums round to float32 apart from the mask
    convolutions by ~2e-6)."""
    kernel = KERNELS[kname]()
    mat, mask, miss_r, miss_c = dense_case(seed=seed, shape=(90, 110))
    mk, nk = kernel.shape
    block = np.pad(mat, ((mk - 1, mk - 1), (nk - 1, nk - 1))).astype(np.float32)
    rv = np.pad(miss_r, (mk - 1, mk - 1), constant_values=True)
    cv = np.pad(miss_c, (nk - 1, nk - 1), constant_values=True)
    ref = jnx.normxcorr_crossing_valid(
        block, rv, cv, kernel, kernel.shape, 0.5, True, 1e-4
    )
    got = tnx.normxcorr_crossing_valid(
        torch.from_numpy(block), torch.from_numpy(rv), torch.from_numpy(cv), kernel,
        0.5, pval=True,
    )
    assert_corr_logp(ref, got)
    full_mask = torch.from_numpy(rv[:, None] | cv[None, :])
    corr, _ = tnx.pearson_valid(torch.from_numpy(block), full_mask, kernel, None, 0.5)
    assert torch.equal(corr != 0, got[0] != 0)
    assert (corr - got[0]).abs().max() < 2e-5


@pytest.mark.parametrize("tsvd", [None, 0.999])
@pytest.mark.parametrize("kname", SHAPES)
def test_xcorr2_matches_jax(kname, tsvd):
    """The public xcorr2 on a dense array and on a sparse matrix (which
    comes back sparse), within float32 rounding of the JAX package's sums
    of up to 289 products (2e-6 of the largest output)."""
    kernel = KERNELS[kname]()
    mat, _, _, _ = dense_case(seed=5)
    ref = np.asarray(jdet.xcorr2(mat, kernel, tsvd=tsvd))
    got = tdet.xcorr2(mat, kernel, tsvd=tsvd, device="cpu")
    tol = 2e-6 * np.abs(ref).max()
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    assert np.abs(got - ref).max() < tol
    got_sp = tdet.xcorr2(sp.csr_matrix(mat), kernel, tsvd=tsvd, device="cpu")
    assert sp.issparse(got_sp)
    assert np.abs(got_sp.toarray() - ref).max() < tol


@pytest.mark.parametrize("full", [False, True])
def test_public_normxcorr2_keeps_the_container(full):
    """numpy in, numpy out; sparse in, sparse out with p-values only where
    corr is non-zero; the same values as the JAX package's normxcorr2."""
    kernel = KERNELS["loops_small"]()
    mat, mask, _, _ = dense_case(seed=7)
    ref = jdet.normxcorr2(mat, kernel, full=full, missing_mask=mask, pval=True)
    got = tdet.normxcorr2(mat, kernel, full=full, missing_mask=mask, pval=True, device="cpu")
    assert isinstance(got[0], np.ndarray)
    assert_corr_logp(ref, [torch.from_numpy(a) for a in got])
    ref_sp = jdet.normxcorr2(
        sp.csr_matrix(mat), kernel, full=full, missing_mask=sp.csr_matrix(mask), pval=True
    )
    got_sp = tdet.normxcorr2(
        sp.csr_matrix(mat), kernel, full=full, missing_mask=sp.csr_matrix(mask), pval=True,
        device="cpu",
    )
    assert sp.issparse(got_sp[0]) and sp.issparse(got_sp[1])
    assert np.array_equal(got_sp[0].toarray() != 0, ref_sp[0].toarray() != 0)
    assert_corr_logp(
        [m.toarray() for m in ref_sp], [torch.from_numpy(m.toarray()) for m in got_sp]
    )


@pytest.mark.parametrize("sym_upper", [False, True])
@pytest.mark.parametrize("max_dist", [None, 12])
@pytest.mark.parametrize("kshape", [(7, 7), (5, 9)])
def test_missing_masks_match_jax(sym_upper, max_dist, kshape):
    _, _, miss_r, miss_c = dense_case(seed=2, shape=(60, 60))
    ref = np.asarray(
        jnx.make_missing_mask_dense((60, 60), miss_r, miss_c, max_dist, sym_upper)
    )
    got = tnx.make_missing_mask_dense(
        (60, 60), torch.from_numpy(miss_r), torch.from_numpy(miss_c), max_dist, sym_upper
    )
    assert np.array_equal(got.numpy(), ref)
    ref_f = np.asarray(jnx.frame_missing_mask_dense(ref, kshape, sym_upper, max_dist))
    got_f = tnx.frame_missing_mask_dense(got, kshape, sym_upper, max_dist)
    assert np.array_equal(got_f.numpy(), ref_f)


@pytest.mark.parametrize("smooth", [False, True])
def test_dense_preprocess_ops_match_jax(smooth):
    """Distance law, detrend, trim and the inter median scale, float32."""
    rng = np.random.RandomState(4)
    n = 80
    mat = rng.rand(n, n) * (rng.rand(n, n) < 0.5) * 5
    mat = (mat + mat.T).astype(np.float32)
    detect = rng.rand(n) > 0.1
    law_j = jpre.distance_law_dense(mat, detect, 40, smooth=smooth)
    law_t = tpre.distance_law_dense(torch.from_numpy(mat), torch.from_numpy(detect), 40, smooth)
    np.testing.assert_allclose(law_t, law_j, rtol=1e-6, equal_nan=True)
    law = np.nan_to_num(law_j).astype(np.float32)
    ref = np.asarray(jpre.detrend_trim_dense(mat, law, 10, 30))
    got = tpre.detrend_trim_dense(torch.from_numpy(mat), torch.from_numpy(law), 10, 30)
    np.testing.assert_array_equal(got.numpy(), ref)
    structure = mat != 0
    structure[::7, ::5] = True
    ref = np.asarray(jpre.inter_median_scale(mat, structure))
    got = tpre.inter_median_scale(torch.from_numpy(mat), torch.from_numpy(structure))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)


class _JaxDenseMap:
    """The JAX detector's dense map stand-in (tests/test_detection.py:37)."""

    def __init__(self, matrix, max_dist=None, detectable_bins=None, inter=False):
        self.dense = np.asarray(matrix, dtype=np.float64)
        self.matrix = sp.csr_matrix(self.dense)
        self.inter = inter
        self.max_dist = max_dist
        self.name = "dummy"
        self.detectable_bins = detectable_bins


def _port_dense_map(matrix, max_dist, detectable_bins, inter):
    cm = ContactMap(
        None, [(0, matrix.shape[0]), (0, matrix.shape[1])], device=torch.device("cpu"),
        detectable_bins=detectable_bins, max_dist=max_dist, inter=inter,
    )
    cm.dense_dev = torch.from_numpy(np.asarray(matrix, dtype=np.float64))
    return cm


def _assert_tables_close(ref, got, windows_ref, windows_got, tol=5e-5):
    assert len(ref) == len(got["bin1"])
    assert np.array_equal(ref.bin1.to_numpy(), got["bin1"])
    assert np.array_equal(ref.bin2.to_numpy(), got["bin2"])
    s_r, s_g = ref.score.to_numpy(), got["score"]
    assert np.array_equal(np.isnan(s_r), np.isnan(s_g))
    ok = ~np.isnan(s_r)
    assert ok.sum() > 0
    assert np.abs(s_r[ok] - s_g[ok]).max() < tol
    p_r, p_g = ref.pvalue.to_numpy(), got["pvalue"]
    assert np.array_equal(np.isnan(p_r), np.isnan(p_g))
    ok = ~np.isnan(p_r)
    assert np.allclose(p_r[ok], p_g[ok], rtol=1e-3, atol=1e-8)
    assert np.array_equal(np.isnan(windows_ref), np.isnan(windows_got))
    np.testing.assert_allclose(windows_got, windows_ref, equal_nan=True)


@pytest.mark.parametrize("mode", ["detect", "quantify"])
@pytest.mark.parametrize("inter", [False, True])
def test_pattern_detector_dense_matches_jax(mode, inter):
    """The dense branch of pattern_detector on an intra map with a scan
    distance (planted loops, tests/test_detection.py:292) and on an inter
    map: the same calls (or quantified pixels), windows and NaN pattern,
    score within 5e-5."""
    rng = np.random.RandomState(8)
    n = 150
    kernel = np.asarray(KERNELS["loops"](), dtype=np.float64)[4:13, 4:13]
    if inter:
        mat = rng.rand(n, n + 20) * (rng.rand(n, n + 20) < 0.9)
        det = (np.flatnonzero(rng.rand(n) > 0.05), np.flatnonzero(rng.rand(n + 20) > 0.05))
        mat[np.setdiff1d(np.arange(n), det[0]), :] = 0
        mat[:, np.setdiff1d(np.arange(n + 20), det[1])] = 0
        max_dist = None
    else:
        i, j = np.indices((n, n))
        mat = np.exp(-np.abs(i - j) / 10.0) + 0.05 * rng.rand(n, n)
        for a, b in ((30, 60), (70, 110), (100, 130)):
            mat[a - 2 : a + 3, b - 2 : b + 3] += 2.0
        mat = np.triu(mat)
        det, max_dist = (np.arange(n), np.arange(n)), 100
    cfg = {"pearson": 0.3, "max_perc_undetected": 50.0, "max_perc_zero": 40.0,
           "max_dist": max_dist or 100}
    coords = None
    if mode == "quantify":
        coords = np.stack([rng.randint(0, n, 30), rng.randint(0, mat.shape[1], 30)], axis=1)
    ref = jdet.pattern_detector(
        _JaxDenseMap(mat, max_dist, det, inter), cfg, kernel, coords=coords, full=True
    )
    got = tdet.pattern_detector(
        _port_dense_map(mat, max_dist, det, inter), cfg, kernel, coords=coords, full=True
    )
    assert ref[0] is not None and got[0] is not None
    _assert_tables_close(ref[0], got[0], ref[1], got[1])


@pytest.mark.parametrize("mode", ["balanced", "raw", "smooth"])
def test_dense_intra_map_matches_jax(tmp_path, mode):
    """An intra map without a scan distance is held dense: fetched,
    detrended by its distance law (isotonic with --smooth-trend) and
    trimmed below the diagonal, raw counts with the missing bins zeroed,
    as a JAX ContactMap does; the same Pearson on it; the 01 and 02
    snapshots of --dump."""
    import contextlib
    import io
    import pathlib
    import shutil

    from chromosight_torch.io.source import ArraySource
    from chromosight_tpu.io.cool import CoolFile
    from chromosight_tpu.runtime.contact_map import ContactMap as JaxContactMap

    root = pathlib.Path(__file__).parents[1]
    cool = tmp_path / "example.cool"
    shutil.copy(root / "data_test" / "example.cool", cool)
    clr, src = CoolFile(str(cool)), ArraySource.from_npz(root / "tests/data/example_cool.npz")
    s, e = clr.extent("chr2")
    valid = np.flatnonzero(np.isfinite(clr.weights[s:e]))
    kw = dict(name="chr2-chr2", detectable_bins=(valid, valid), largest_kernel=17,
              use_norm=mode != "raw", smooth=mode == "smooth")
    jcm = JaxContactMap(clr, [(s, e), (s, e)], **kw, dump=str(tmp_path / "jax"))
    cm = ContactMap(src, [(s, e), (s, e)], device=torch.device("cpu"), **kw, dump=str(tmp_path / "port"))
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    with contextlib.redirect_stdout(io.StringIO()):
        jcm.create_mat()
        cm.create_mat()
    assert cm.band is None and cm.sparse is None
    ref, got = np.asarray(jcm.dense), cm.dense_dev.numpy()
    assert np.array_equal(ref == 0, got == 0) and (got != 0).sum() > 1000
    assert np.allclose(got, ref, rtol=1e-6, atol=0)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 2
    for name in names:
        a = sp.load_npz(tmp_path / "jax" / name).toarray()
        b = sp.load_npz(tmp_path / "port" / name).toarray()
        assert np.allclose(b, a, rtol=1e-6, atol=0, equal_nan=True), name
    kernel = KERNELS["loops"]()
    miss = ~np.isin(np.arange(e - s), valid)
    mask = np.array(jnx.make_missing_mask_dense(ref.shape, miss, miss, None, True))
    args = dict(full=True, sym_upper=True, pval=True, missing_tol=0.5)
    corr_ref = jnx.normxcorr2_dense(ref, kernel, missing_mask=mask, **args)
    corr_got = tnx.normxcorr2_dense(cm.dense_dev, kernel, missing_mask=torch.from_numpy(mask), **args)
    assert_corr_logp(corr_ref, corr_got, corr_tol=5e-5)
