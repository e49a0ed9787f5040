"""The CPU baselines of the genome bench: what ``vs_baseline`` divides by.

The port's own copies of ``bench.py:164-340``:

* ``run_reference_engine`` times the reference chromosight's own sparse
  engine (``chromosight.utils.detection.normxcorr2`` full mode with the
  missing mask and p-values) on a detrended band slice, only where the
  caller names the reference tree (``reference_dir``, or the
  ``CHROMOSIGHT_REFERENCE_DIR`` variable) and it imports.  It returns
  None otherwise: it never looks for the tree outside the checkout by
  itself, so what the bench times does not depend on what lies beside
  it.
* ``baseline_band`` is that slice, read through the port's
  ``CoolFile.band_upper``.
* ``run_baseline`` is the same-math reimplementation (one banded
  Toeplitz matmul per kernel row, six convolutions and the
  missing-corrected Pearson in scipy), timed where the reference engine
  returns None.

One departure from ``bench.py``: it has no default reference tree
(``bench.py`` looks in a fixed directory outside its checkout).
"""

from __future__ import annotations

import importlib
import os
import pathlib
import sys
import time

import numpy as np

def run_reference_engine(band, missing, K, max_dist, reference_dir=None):
    """Seconds the reference's own sparse engine takes on the detrended
    band slice (``band``, ``missing``), or None where no reference tree
    is named (``reference_dir``, else ``CHROMOSIGHT_REFERENCE_DIR``) or
    it does not import.  Its detection and preprocessing modules need only
    numpy, scipy and sklearn, so the engine runs unmodified."""
    import scipy.sparse as sp

    reference_dir = reference_dir or os.environ.get("CHROMOSIGHT_REFERENCE_DIR")
    if not reference_dir or not (pathlib.Path(reference_dir) / "chromosight").is_dir():
        return None
    sys.path.insert(0, str(reference_dir))
    try:
        refdet = importlib.import_module("chromosight.utils.detection")
        refpre = importlib.import_module("chromosight.utils.preprocessing")
    except Exception:
        sys.path.pop(0)
        return None
    try:
        n, width = band.shape
        i, d = np.nonzero(band)
        j = i + d
        ok = j < n
        signal = sp.coo_matrix(
            (band[i[ok], d[ok]], (i[ok], j[ok])), shape=(n, n)
        ).tocsr()
        valid = np.flatnonzero(~missing)
        t0 = time.perf_counter()
        mask = refpre.make_missing_mask(
            signal.shape,
            valid_rows=valid,
            valid_cols=valid,
            max_dist=max_dist,
            sym_upper=True,
        )
        corr, _pvals = refdet.normxcorr2(
            signal,
            np.asarray(K, np.float64),
            max_dist=max_dist,
            sym_upper=True,
            full=True,
            missing_mask=mask,
            missing_tol=0.5,
            pval=True,
        )
        dt = time.perf_counter() - t0
        _ = (corr >= 0.3).sum()  # touch the result
        return dt
    except Exception as exc:
        # the timed passes already ran: the bench falls back to the
        # reimplementation when this returns None
        print(f"reference engine failed ({exc!r}); falling back", file=sys.stderr)
        return None
    finally:
        sys.path.pop(0)


def baseline_band(cool_path, nb, width):
    """First ``nb`` bins of the first chromosome as an (nb, width)
    detrended band (the pipeline's preprocessing, host numpy)."""
    from chromosight_torch.io.cool import CoolFile

    clr = CoolFile(str(cool_path))
    s, e = clr.extent(clr.chromnames[0])
    e = min(e, s + nb)
    band = clr.band_upper((s, e), width, balance=True)
    band = np.nan_to_num(band, nan=0.0)
    missing = ~band.any(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        law = band.sum(0) / np.maximum((band > 0).sum(0), 1)
        band = np.where(band != 0, band / law[None, :], 0.0)
    band[band >= 10] = 1.0
    return band.astype(np.float64), missing


def run_baseline(band, missing, K, max_dist):
    """Reference-style engine: one banded-Toeplitz matmul per kernel row
    (reference detection.py:699-713) x 6 convolutions + the
    missing-corrected Pearson algebra.  (seconds, candidates at 0.3)."""
    import scipy.sparse as sp

    n, width = band.shape
    i, d = np.nonzero(band)
    j = i + d
    ok = j < n
    signal = sp.coo_matrix(
        (band[i[ok], d[ok]], (i[ok], j[ok])), shape=(n, n)
    ).tocsr()
    mk, nk = K.shape

    def frame(mat):
        m = sp.csr_matrix((mk - 1, mat.shape[1]))
        out = sp.vstack([m, mat, m], format="csr")
        m2 = sp.csr_matrix((out.shape[0], nk - 1))
        return sp.hstack([m2, out, m2], format="csr")

    t0 = time.perf_counter()
    framed = frame(signal)
    mi = np.flatnonzero(missing)
    shifts = np.arange(max_dist + 1)
    rr = np.concatenate(
        [(mi[:, None] - shifts[None, :]).ravel(), np.repeat(mi, max_dist + 1)]
    )
    cc = np.concatenate(
        [np.repeat(mi, max_dist + 1), (mi[:, None] + shifts[None, :]).ravel()]
    )
    okm = (rr >= 0) & (rr < n) & (cc >= 0) & (cc < n)
    mask = sp.coo_matrix(
        (np.ones(okm.sum()), (rr[okm], cc[okm])), shape=(n, n)
    ).tocsr()
    mask.data[:] = 1
    framed_mask = frame(mask)
    big_k = max(mk, nk)
    framed_mask = (
        framed_mask
        + sp.diags(
            np.ones(big_k),
            -np.arange(1, big_k + 1),
            shape=framed_mask.shape,
            format="csr",
        )
    ).tocsr()
    framed_mask.data[:] = 1

    def xcorr_sparse(mat, kern):
        sm, sn = mat.shape
        km, kn_ = kern.shape
        out = None
        for ki in range(km):
            sub = sp.diags(
                kern[ki, :],
                np.arange(kn_),
                shape=(sn - kn_ + 1, sn),
                format="csr",
            )
            term = mat[ki : sm - km + 1 + ki, :].dot(sub.T)
            out = term if out is None else out + term
        out.data[np.abs(out.data) < 1e-4] = 0
        out.eliminate_zeros()
        return out

    ksize = mk * nk
    kernel1 = np.ones(K.shape)
    ksum, k2sum = K.sum(), (K**2).sum()
    sig_mean = xcorr_sparse(framed, kernel1 / ksize)
    sig2 = framed.copy()
    sig2.data = sig2.data**2
    sig2_mean = xcorr_sparse(sig2, kernel1 / ksize)
    conv_k = xcorr_sparse(framed, K / ksize)
    n_miss = xcorr_sparse(framed_mask, kernel1)
    conv_mk = xcorr_sparse(framed_mask, K)
    conv_mk2 = xcorr_sparse(framed_mask, K**2)
    npres = ksize - n_miss.toarray()
    with np.errstate(divide="ignore", invalid="ignore"):
        kmean_eff = (ksum - conv_mk.toarray()) / npres
        k2mean_eff = (k2sum - conv_mk2.toarray()) / npres
        corr_f = ksize / npres
        sm_ = sig_mean.toarray() * corr_f
        s2m = sig2_mean.toarray() * corr_f
        denom = np.sqrt((s2m - sm_**2) * (k2mean_eff - kmean_eff**2))
        denom[npres < int(0.5 * ksize)] = 0
        num = (conv_k.toarray() - sm_ * kmean_eff / corr_f) * corr_f
        corr = np.where(np.abs(denom) < 1e-10, 0.0, num / denom)
    corr[~np.isfinite(corr)] = 0
    np.clip(corr, -1, 1, out=corr)
    cand = (corr >= 0.3).sum()
    return time.perf_counter() - t0, int(cand)
