"""The port's halo-tiled sparse engine against the JAX package's and
against the port's own dense engine, on CPU at tile 64: the sliding
Pearson of a 300 x 420 sparse map with the missing bins given as two
vectors (the crossing collapse of inter maps), as a full sparse mask (also
upper-symmetric and banded), or with no mask; the candidate-only output
of detect mode (``keep_min``); the window sums by dense conv2d or by
scatter-add of a sparse batch's entries; ``--tsvd``; the sparse
cross-correlation; and the skipping of tiles whose block holds no
signal."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import chromosight_torch.observability as obs
import chromosight_torch.ops.tiled as ttiled
import chromosight_tpu.preprocessing as jpre
import chromosight_torch.ops.convolve as convolve
from chromosight_torch.ops.convolve import xcorr2 as t_xcorr2_dense
from chromosight_torch.ops.normxcorr import normxcorr2_dense
from chromosight_tpu.ops.tiled import normxcorr2_sparse_tiled as j_tiled
from chromosight_tpu.ops.tiled import xcorr2_sparse_tiled as j_xcorr2_tiled
from torch_parity import KERNELS, torch_one_thread  # noqa: F401

TILE = 64
SHAPE = (300, 420)


def sparse_case(seed=0, shape=SHAPE, density=0.2, sym_upper=False):
    """(CSR signal float64, missing rows, missing cols): missing rows and
    columns zeroed; upper triangular when ``sym_upper``."""
    rng = np.random.RandomState(seed)
    mat = rng.rand(*shape) * 3 * (rng.rand(*shape) < density)
    miss_r = rng.rand(shape[0]) < 0.05
    miss_c = miss_r if sym_upper else rng.rand(shape[1]) < 0.05
    if sym_upper:
        mat = np.triu(mat)
    mat[miss_r, :] = 0
    mat[:, miss_c] = 0
    return sp.csr_matrix(mat), miss_r, miss_c


def _kwargs(form, miss_r, miss_c, shape, max_dist=None):
    """Engine arguments of a mask form, for both packages."""
    if form == "vectors":
        return dict(missing_vectors=(miss_r, miss_c))
    if form == "none":
        return {}
    sym_upper = form != "full"
    mask = jpre.make_missing_mask(
        shape, np.flatnonzero(~miss_r), np.flatnonzero(~miss_c), max_dist=max_dist,
        sym_upper=sym_upper,
    )
    return dict(missing_mask=mask, sym_upper=sym_upper, max_dist=max_dist)


def assert_same_csr(ref, got, corr_tol=2e-5, keep_min=None):
    """The same stored pixels and values within ``corr_tol``: a pixel
    stored on one side only holds a value within ``corr_tol`` of 0 (a
    near-zero coefficient rounded to zero), or within 1e-4 of
    ``keep_min`` (a candidate flip at the threshold)."""
    ref, got = ref.tocsr(), got.tocsr()
    ref.eliminate_zeros()
    got.eliminate_zeros()
    a, b = ref.toarray(), got.toarray()
    flips = (a != 0) != (b != 0)
    lone = np.where(a != 0, a, b)[flips]
    near = np.abs(lone) < corr_tol
    if keep_min is not None:
        near |= np.abs(lone - keep_min) < 1e-4
    assert np.all(near) and flips.sum() <= 3
    both = (a != 0) & (b != 0)
    assert both.sum() > 50
    assert np.abs(a[both] - b[both]).max() < corr_tol
    return both


@pytest.mark.parametrize("numerator", ["conv2d", "scatter"])
@pytest.mark.parametrize("keep_min", [None, 0.1])
@pytest.mark.parametrize("form", ["vectors", "full", "none"])
def test_tiled_matches_jax_and_dense(form, keep_min, numerator, monkeypatch):
    """The tiled Pearson at tile 64 against the JAX tiled engine at tile 64
    and the port's dense engine on the whole map: identical non-zero
    pattern, corr within 2e-5, log10-p within 2e-3 where both are kept;
    the window sums by dense conv2d or by scatter-add of the entries."""
    monkeypatch.setattr(ttiled, "SCATTER_DENSITY", 1.0 if numerator == "scatter" else 0.0)
    kernel = KERNELS["loops"]()
    signal, miss_r, miss_c = sparse_case()
    args = dict(full=True, pval=True, missing_tol=0.5, keep_min=keep_min)
    kw = _kwargs(form, miss_r, miss_c, signal.shape)
    ref = j_tiled(signal, kernel, tile=TILE, **args, **kw)
    before = obs.counters()
    got = ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=TILE, device="cpu", **args, **kw)
    after = obs.counters()
    seen = sum(after[k] - before.get(k, 0) for k in ("tiles: scanned", "tiles: skipped"))
    assert seen == 6 * 8  # the framed 332 x 452 map
    assert all(sp.issparse(m) and m.shape == SHAPE for m in got)
    both = assert_same_csr(ref[0], got[0], keep_min=keep_min)
    lr, lg = ref[1].toarray()[both], got[1].toarray()[both]
    assert np.abs(lr - lg).max() < 2e-3
    if keep_min is not None:
        assert got[0].data.min() >= keep_min
    # the port's dense engine on the whole map
    mask = None
    if form != "none":
        mask = torch.from_numpy(miss_r[:, None] | miss_c[None, :])
    corr_d, _ = normxcorr2_dense(
        torch.from_numpy(signal.toarray()), kernel, full=True, missing_mask=mask,
        missing_tol=0.5, pval=True, sym_upper=kw.get("sym_upper", False),
    )
    dense = corr_d.numpy()
    if keep_min is not None:
        dense = np.where(dense >= keep_min, dense, 0)
    assert_same_csr(sp.csr_matrix(dense), got[0], keep_min=keep_min)


@pytest.mark.parametrize("kname", ["loops_small", "rect5x9"])
@pytest.mark.parametrize("max_dist", [None, 40])
def test_tiled_upper_symmetric_matches_jax(kname, max_dist):
    """An intra map through the public sparse path: upper-symmetric
    missing mask (banded frame rules with a scan distance), the triangle
    rule in framed coordinates."""
    kernel = KERNELS[kname]()
    signal, miss_r, miss_c = sparse_case(seed=2, shape=(260, 260), sym_upper=True)
    kw = _kwargs("sym", miss_r, miss_c, signal.shape, max_dist)
    args = dict(full=True, pval=True, missing_tol=0.5, **kw)
    ref = j_tiled(signal, kernel, tile=TILE, **args)
    got = ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=TILE, device="cpu", **args)
    both = assert_same_csr(ref[0], got[0])
    assert np.abs(ref[1].toarray()[both] - got[1].toarray()[both]).max() < 2e-3


def test_tiled_tsvd_matches_jax():
    """--tsvd factors with vector masks (no crossing collapse then)."""
    kernel = KERNELS["loops"]()
    signal, miss_r, miss_c = sparse_case(seed=3)
    args = dict(full=True, pval=True, missing_tol=0.5, tsvd=0.999,
                missing_vectors=(miss_r, miss_c))
    ref = j_tiled(signal, kernel, tile=TILE, **args)
    got = ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=TILE, device="cpu", **args)
    assert_same_csr(ref[0], got[0])


@pytest.mark.parametrize("full", [False, True])
def test_tiled_unframed_and_tile_sizes(full):
    """Without framing, and at a tile smaller than the kernel's halo
    (tile 8 with a 17x17 kernel: each entry in up to nine blocks), the
    result does not depend on the tile size."""
    kernel = KERNELS["loops"]()
    signal, miss_r, miss_c = sparse_case(seed=4, shape=(90, 110))
    args = dict(full=full, pval=True, missing_tol=0.5, missing_vectors=(miss_r, miss_c))
    ref = ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=TILE, device="cpu", **args)
    small = ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=8, device="cpu", **args)
    jax_ref = j_tiled(signal, kernel, tile=TILE, **args)
    for got in (small, jax_ref):
        assert_same_csr(ref[0], got[0])


def test_tiled_skips_empty_tiles():
    """Tiles whose block holds no signal are skipped: a map with an empty
    half gives the same result as the JAX engine and counts the skips."""
    kernel = KERNELS["loops_small"]()
    signal, miss_r, miss_c = sparse_case(seed=5)
    signal = signal.tolil()
    signal[:, 200:] = 0
    signal = signal.tocsr()
    args = dict(full=True, pval=True, missing_tol=0.5, missing_vectors=(miss_r, miss_c))
    before = obs.counters()
    got = ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=TILE, device="cpu", **args)
    after = obs.counters()
    scanned = after["tiles: scanned"] - before.get("tiles: scanned", 0)
    skipped = after["tiles: skipped"] - before.get("tiles: skipped", 0)
    assert scanned + skipped == 5 * 7 and skipped >= 10  # the framed 316 x 436 map
    assert_same_csr(j_tiled(signal, kernel, tile=TILE, **args)[0], got[0])


@pytest.mark.parametrize("chunk", [1 << 24, 40])
@pytest.mark.parametrize("kshape", [(17, 17), (5, 9), (9, 3)])
@pytest.mark.parametrize("density", [0.01, 0.3])
def test_window_sums_entries_match_dense(kshape, density, chunk, monkeypatch):
    """The scatter-add planes of a stack's stored entries (correlation with
    the kernel, window sums of x and x^2), in one step or in steps of a
    tap row, equal the dense float64 correlations of the stack."""
    monkeypatch.setattr(convolve, "ENTRY_CHUNK", chunk)
    rng = np.random.RandomState(8)
    stack = rng.rand(3, 70, 90) * (rng.rand(3, 70, 90) < density)
    x = torch.from_numpy(stack.astype(np.float32))
    kernel = torch.from_numpy(rng.rand(*kshape).astype(np.float32))
    slot, rows, cols = torch.nonzero(x, as_tuple=True)
    got = convolve.window_sums_entries(slot, rows, cols, x[slot, rows, cols], x.shape, kernel)
    ref = (
        convolve.conv2d_valid(x, kernel),
        convolve.window_sum_valid(x, kshape),
        convolve.window_sum_valid(x.double() ** 2, kshape),
    )
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64 and a.shape == b.shape
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "factorised,density", [(False, 0.0), (False, 1.0), (True, ttiled.SCATTER_DENSITY)]
)
def test_xcorr2_sparse_tiled_matches_jax_and_dense(factorised, density, monkeypatch):
    """The sparse cross-correlation against the JAX tiled engine and the
    port's dense xcorr2, within float32 rounding of 289-term sums; a full
    kernel by conv2d or by scatter-add of the entries (``density``)."""
    from chromosight_torch.preprocessing import factorise_kernel

    monkeypatch.setattr(ttiled, "SCATTER_DENSITY", density)

    kernel = KERNELS["loops"]()
    if factorised:
        kernel = factorise_kernel(kernel, prop_info=0.999)
    signal, _, _ = sparse_case(seed=6)
    got = ttiled.xcorr2_sparse_tiled(signal, kernel, tile=TILE, device="cpu")
    ref = j_xcorr2_tiled(signal, kernel, tile=TILE)
    dense = t_xcorr2_dense(torch.from_numpy(signal.toarray()).float(), kernel).numpy()
    tol = 2e-6 * np.abs(dense).max()
    assert got.shape == SHAPE
    for other in (ref.toarray(), dense):
        assert np.abs(got.toarray() - other).max() < tol


def test_tiled_refusals():
    signal, miss_r, miss_c = sparse_case(seed=7, shape=(60, 60))
    kernel = KERNELS["loops_small"]()
    with pytest.raises(ValueError, match="sym_upper"):
        ttiled.normxcorr2_sparse_tiled(
            signal, kernel, sym_upper=True, missing_vectors=(miss_r, miss_c), device="cpu"
        )
    with pytest.raises(ValueError, match="not both"):
        ttiled.normxcorr2_sparse_tiled(
            signal, kernel, missing_vectors=(miss_r, miss_c),
            missing_mask=sp.csr_matrix(np.zeros((60, 60), bool)), device="cpu",
        )
    with pytest.raises(ValueError, match="positive"):
        ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=0, device="cpu")


def test_tiled_needs_a_device_without_a_card(monkeypatch):
    """Called without a device, both public functions mean the first CUDA
    card: without one they raise, and never run on the CPU unasked; a
    device list spreads the batches and gives the one-device result."""
    signal = sparse_case(3)[0]
    kernel = np.asarray(KERNELS["loops_small"](), np.float32)
    one = ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=TILE, device="cpu")[0]
    two = ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=TILE, device=["cpu", "cpu"])[0]
    assert one.nnz > 0 and (one != two).nnz == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ttiled.normxcorr2_sparse_tiled(signal, kernel, tile=TILE)
    with pytest.raises(RuntimeError, match="is_available"):
        ttiled.xcorr2_sparse_tiled(signal, kernel, tile=TILE)
