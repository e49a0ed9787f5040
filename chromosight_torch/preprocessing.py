"""Host helpers for bins, the distance law, kernels and sparse masks.

The port's copies of the functions of ``chromosight_tpu/preprocessing.py``
that it calls or publishes, with the same arithmetic:
``valid_to_missing``, ``missing_flags``, ``diag_trim``,
``pava_decreasing``, ``erase_missing``, ``set_mat_diag``,
``distance_law``, ``detrend``, ``ztransform``, ``sum_mat_bins``,
``get_detectable_bins``, ``make_missing_mask``, ``frame_missing_mask``,
``check_missing_mask``, ``zero_pad_sparse``, ``crop_kernel``,
``resize_kernel``, ``factorise_kernel`` and ``subsample_contacts``
(which draws from a ``numpy.random.RandomState`` it is given, not from
numpy's global state).  scipy is imported by the functions that need
it, when they run.
"""

from __future__ import annotations

import sys

import numpy as np


def valid_to_missing(valid, size):
    """Complement of an array of valid indices within [0, size)."""
    flags = np.ones(size, dtype=bool)
    valid = np.asarray(valid)
    inb = valid[(valid >= 0) & (valid < size)] if valid.size else valid
    flags[inb.astype(np.int64)] = False
    return np.flatnonzero(flags)


def missing_flags(valid, size):
    """Boolean missing-bin vector (True = missing) from valid indices."""
    flags = np.ones(size, dtype=bool)
    valid = np.asarray(valid, dtype=np.int64)
    if valid.size:
        flags[valid[(valid >= 0) & (valid < size)]] = False
    return flags


def diag_trim(mat, n):
    """Keep only the first ``n`` upper diagonals: a CSR matrix becomes
    its upper triangle with diagonals 0..n; a dense array gets its upper
    diagonals >= n zeroed, its lower triangle untouched."""
    import scipy.sparse as sp

    if sp.issparse(mat):
        if mat.format != "csr":
            raise ValueError("input type must be scipy.sparse.csr_matrix")
        coo = mat.tocoo()
        d = coo.col - coo.row
        keep = (d >= 0) & (d <= n)
        return sp.coo_matrix(
            (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=mat.shape
        ).tocsr()
    out = np.array(mat, copy=True)
    i, j = np.indices(out.shape, sparse=True)
    out[(j - i) >= n] = 0
    return out


def pava_decreasing(y):
    """Pool-adjacent-violators algorithm for a non-increasing fit with
    uniform weights (equivalent to
    sklearn.isotonic.IsotonicRegression(increasing=False), used by the
    reference at ``preprocessing.py:192-195``)."""
    y = np.asarray(y, dtype=np.float64)
    n = len(y)
    # Antitonic regression on y == isotonic regression on reversed y.
    vals = list(y[::-1])
    means = []
    counts = []
    for v in vals:
        means.append(v)
        counts.append(1)
        # Merge blocks while monotonicity (non-decreasing) is violated
        while len(means) > 1 and means[-2] > means[-1]:
            total = counts[-2] + counts[-1]
            merged = (means[-2] * counts[-2] + means[-1] * counts[-1]) / total
            means[-2:] = [merged]
            counts[-2:] = [total]
    fit = np.repeat(means, counts)
    return fit[::-1][:n]


def erase_missing(signal, valid_rows, valid_cols, sym_upper=True):
    """Zero all pixels falling in missing (non-valid) bins.

    Reference: ``preprocessing.py:19-68``.
    """
    import scipy.sparse as sp

    if sym_upper and sp.issparse(signal):
        if np.any(np.asarray(valid_rows) != np.asarray(valid_cols)):
            raise ValueError(
                "Valid rows and columns must be identical with sym_upper=True"
            )
        if signal.shape[0] != signal.shape[1]:
            raise ValueError(
                "Input matrix must be square when using sym_upper=True"
            )
        coo = signal.tocoo(copy=True)
        good = np.zeros(signal.shape[0], dtype=bool)
        good[np.asarray(valid_rows, dtype=np.int64)] = True
        keep = good[coo.row] & good[coo.col]
        data = np.where(keep, coo.data, 0)
        out = sp.coo_matrix((data, (coo.row, coo.col)), shape=coo.shape)
        return out.tocsr()
    missing_rows = valid_to_missing(valid_rows, signal.shape[0])
    missing_cols = valid_to_missing(valid_cols, signal.shape[1])
    if sp.issparse(signal):
        erased = signal.tolil(copy=True)
        erased[missing_rows, :] = 0
        erased[:, missing_cols] = 0
        return erased.tocsr()
    erased = np.array(signal, copy=True)
    erased[missing_rows, :] = 0
    erased[:, missing_cols] = 0
    return erased


def set_mat_diag(mat, diag=0, val=0):
    """Set the nth (upper, 0-based) diagonal of a dense array in place.

    Reference: ``preprocessing.py:71-90``.
    """
    m = mat.shape[0]
    idx = np.arange(max(m - abs(diag), 0))
    if diag >= 0:
        mat[idx, idx + diag] = val
    else:
        mat[idx - diag, idx] = val


def distance_law(
    matrix, detectable_bins=None, max_dist=None, smooth=True, fun=np.nanmean
):
    """Per-diagonal average of the upper triangle (the genomic distance law).

    Reference: ``preprocessing.py:129-197``.  Only diagonals up to
    ``max_dist`` are computed; pixels in non-detectable bins and
    non-positive pixels are excluded from each diagonal's average.
    """
    import scipy.sparse as sp

    matrix = matrix.tocsr() if sp.issparse(matrix) else sp.csr_matrix(matrix)
    mat_n = matrix.shape[0]
    if max_dist is None:
        max_dist = mat_n
    n_diags = min(mat_n, max_dist + 1)
    dist = np.zeros(mat_n)
    if detectable_bins is None:
        detect = np.ones(mat_n, dtype=bool)
    else:
        detect = np.zeros(mat_n, dtype=bool)
        detect[np.asarray(detectable_bins, dtype=np.int64)] = True

    if fun is np.nanmean:
        # one bincount pass over the positive, detectable upper-triangle
        # entries, grouped by diagonal
        coo = matrix.tocoo()
        d = coo.col - coo.row
        sel = (
            (d >= 0)
            & (d < n_diags)
            & detect[coo.row]
            & detect[coo.col]
            & (coo.data > 0)
        )
        sums = np.bincount(d[sel], weights=coo.data[sel], minlength=n_diags)
        counts = np.bincount(d[sel], minlength=n_diags)
        with np.errstate(invalid="ignore", divide="ignore"):
            dist[:n_diags] = sums[:n_diags] / counts[:n_diags]
    else:
        for diag in range(n_diags):
            vals = matrix.diagonal(diag)
            dmask = detect[: mat_n - diag] & detect[diag:]
            vals = vals[dmask]
            vals = vals[vals > 0]
            dist[diag] = fun(vals) if len(vals) else np.nan

    if smooth and mat_n > 2:
        dist[~np.isfinite(dist)] = 0
        dist = pava_decreasing(dist)
    return dist


def detrend(
    matrix,
    detectable_bins=None,
    max_dist=None,
    smooth=False,
    fun=np.nanmean,
    max_val=10,
):
    """Divide each pixel by the distance-law value at its diagonal.

    Reference: ``preprocessing.py:256-310``, including the quirk that
    detrended values >= ``max_val`` are reset to **1** (not clipped).
    """
    import scipy.sparse as sp

    matrix = matrix.tocsr() if sp.issparse(matrix) else sp.csr_matrix(matrix)
    law = distance_law(
        matrix,
        detectable_bins=detectable_bins,
        max_dist=max_dist,
        smooth=smooth,
        fun=fun,
    )
    law[np.isnan(law)] = 0.0
    coo = matrix.tocoo(copy=True)
    if len(coo.data):
        with np.errstate(invalid="ignore", divide="ignore"):
            coo.data = coo.data / law[np.abs(coo.row - coo.col)]
    out = coo.tocsr()
    if max_val is not None:
        big = out.data >= max_val
        out.data[big] = 1
    return out


def ztransform(matrix):
    """Standardise the explicit entries of a sparse matrix.

    Reference: ``preprocessing.py:313-334``.
    """
    import scipy.sparse as sp

    mat = matrix.copy()
    if sp.issparse(mat):
        mu, sd = np.mean(mat.data), np.std(mat.data)
        mat.data = (mat.data - mu) / sd
    else:
        mu, sd = np.mean(mat), np.std(mat)
        mat = (mat - mu) / sd
    return mat


def sum_mat_bins(mat):
    """Per-bin sums of a symmetric matrix given either triangle or both.

    Reference: ``preprocessing.py:337-356``.
    """
    row = np.asarray(mat.sum(axis=0)).ravel()
    col = np.asarray(mat.sum(axis=1)).ravel()
    return row + col - mat.diagonal(0)


def get_detectable_bins(mat, n_mads=3, inter=False):
    """MAD filter on bin coverage to find detectable rows/columns.

    Reference: ``preprocessing.py:200-253``.
    """
    import scipy.sparse as sp

    matrix = mat.copy().tocoo() if sp.issparse(mat) else sp.coo_matrix(mat)
    matrix.eliminate_zeros()

    def mad(x):
        x = np.asarray(x, dtype=np.float64)
        x = x[~np.isnan(x)]
        med = np.median(x)
        return np.median(np.abs(x - med))

    if not inter:
        if matrix.shape[0] != matrix.shape[1]:
            raise ValueError("Intrachromosomal matrices must be symmetric.")
        # the share of non-zero pixels of each bin
        binary = matrix.copy()
        binary.data = np.ones_like(binary.data)
        sum_bins = sum_mat_bins(binary)
        sum_mad = mad(sum_bins)
        sum_med = np.median(sum_bins)
        detect_threshold = max(1, sum_med - sum_mad * n_mads)
        good_bins = np.flatnonzero(sum_bins >= detect_threshold)
        return (good_bins, good_bins)
    sum_rows = np.asarray(matrix.sum(axis=1)).ravel()
    sum_cols = np.asarray(matrix.sum(axis=0)).ravel()
    thr_rows = max(1, np.median(sum_rows) - mad(sum_rows) * n_mads)
    thr_cols = max(1, np.median(sum_cols) - mad(sum_cols) * n_mads)
    return (
        np.flatnonzero(sum_rows > thr_rows),
        np.flatnonzero(sum_cols > thr_cols),
    )


def make_missing_mask(
    shape, valid_rows, valid_cols, max_dist=None, sym_upper=False
):
    """Sparse boolean CSR mask of missing pixels (True = missing): full
    crosses of the missing rows and columns, or for upper-symmetric maps
    each missing bin's row segment rightwards and column segment upwards
    over ``max_dist`` + 1 pixels."""
    import scipy.sparse as sp

    sm, sn = shape
    if sym_upper and (sm != sn or len(valid_rows) != len(valid_cols)):
        raise ValueError("Rectangular matrices cannot be upper symmetric")
    miss_r = missing_flags(valid_rows, sm)
    miss_c = miss_r if sym_upper else missing_flags(valid_cols, sn)
    if sym_upper:
        md = min(shape) if max_dist is None else max_dist
        mrows = np.flatnonzero(miss_r)
        shifts = np.arange(md + 1)
        up_r = (mrows[:, None] - shifts[None, :]).ravel()
        up_c = np.repeat(mrows, md + 1)
        rt_r = np.repeat(mrows, md + 1)
        rt_c = (mrows[:, None] + shifts[None, :]).ravel()
        rows = np.concatenate([up_r, rt_r])
        cols = np.concatenate([up_c, rt_c])
        ok = (rows >= 0) & (rows < sm) & (cols >= 0) & (cols < sm)
        mask = sp.coo_matrix(
            (np.ones(ok.sum(), dtype=bool), (rows[ok], cols[ok])),
            shape=shape,
            dtype=bool,
        ).tocsr()
        mask.data = mask.data > 0
        return mask
    mask = sp.lil_matrix(shape, dtype=bool)
    mask[np.flatnonzero(miss_r), :] = True
    mask[:, np.flatnonzero(miss_c)] = True
    return mask.tocsr()


def frame_missing_mask(mask, kernel_shape, sym_upper=False, max_dist=None):
    """Add kernel-sized margins around a sparse missing mask, by the
    region rules of ``ops.normxcorr.frame_missing_mask_dense`` enumerated
    in COO coordinates (O(n * kernel) entries, never densified)."""
    import scipy.sparse as sp

    if mask.dtype != bool:
        raise ValueError("Mask must contain boolean values")
    if not sp.issparse(mask):
        raise ValueError("Mask must be a sparse matrix")
    ms, ns = mask.shape
    mk, nk = kernel_shape
    big_k = max(mk, nk)
    banded = sym_upper and (max_dist is not None)
    fm, fn = ms + 2 * (mk - 1), ns + 2 * (nk - 1)
    coo = mask.tocoo()
    r_in = coo.row.astype(np.int64) + (mk - 1)
    c_in = coo.col.astype(np.int64) + (nk - 1)
    if banded:
        d = coo.col.astype(np.int64) - coo.row.astype(np.int64)
        keep = (d >= 0) & (d <= max_dist + big_k)
        r_in, c_in = r_in[keep], c_in[keep]
    regions = [(r_in, c_in)]

    def rect(r0, r1, c0, c1):
        r0, c0 = max(r0, 0), max(c0, 0)
        r1, c1 = min(r1, fm), min(c1, fn)
        if r1 <= r0 or c1 <= c0:
            return
        rr = np.arange(r0, r1, dtype=np.int64)
        cc = np.arange(c0, c1, dtype=np.int64)
        regions.append((np.repeat(rr, len(cc)), np.tile(cc, len(rr))))

    if banded:
        max_m, max_n = max_dist + mk, max_dist + nk
        rect(0, mk - 1, nk - 1, nk - 1 + min(ns, max_n))
        rect(0, mk - 1, 0, nk - 1)
        rect(fm - (max_m + 1), fm, nk - 1 + ns, fn)
    else:
        rect(0, mk - 1, 0, fn)
        rect(mk - 1 + ms, fm, 0, fn)
        rect(mk - 1, mk - 1 + ms, 0, nk - 1)
        rect(mk - 1, mk - 1 + ms, nk - 1 + ns, fn)
    if sym_upper:
        for off in range(1, big_k + 1):
            rr = np.arange(off, min(fm, fn + off), dtype=np.int64)
            regions.append((rr, rr - off))
    rows = np.concatenate([r for r, _ in regions])
    cols = np.concatenate([c for _, c in regions])
    framed = sp.coo_matrix(
        (np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(fm, fn)
    ).tocsr()
    framed.data = framed.data > 0
    return framed.astype(bool)


def check_missing_mask(signal, mask):
    """Raise when a pixel marked missing holds a non-zero signal."""
    import scipy.sparse as sp

    if sp.issparse(mask):
        mr, mc = mask.nonzero()
        bad = np.count_nonzero(np.abs(np.asarray(signal[mr, mc])).ravel() > 0)
        if bad > 0:
            raise ValueError(
                f"There are {bad} non-zero elements reported as missing."
            )
    else:
        total = np.sum(np.abs(np.asarray(signal)[np.asarray(mask) > 0]))
        if total > 1e-10:
            raise ValueError(
                f"There are {total} non-zero elements reported as missing."
            )


def zero_pad_sparse(mat, margin_h, margin_v, fmt="coo"):
    """Surround a sparse matrix with margins of zeros (``margin_v`` rows
    above and below, ``margin_h`` columns left and right)."""
    import scipy.sparse as sp

    sm, sn = mat.shape
    coo = mat.tocoo()
    out = sp.coo_matrix(
        (coo.data, (coo.row + margin_v, coo.col + margin_h)),
        shape=(sm + 2 * margin_v, sn + 2 * margin_h),
        dtype=mat.dtype,
    )
    return out.asformat(fmt)


def crop_kernel(kernel, target_size):
    """Symmetric crop of a kernel to (odd) target dimensions.

    Reference: ``preprocessing.py:679-728``.
    """
    target = list(target_size)
    adjusted = False
    for dim in range(len(target)):
        if not target[dim] % 2:
            target[dim] += 1
            adjusted = True
    if adjusted:
        sys.stderr.write(
            "WARNING: Cropped kernel size adjusted to "
            f"{target[0]}x{target[1]} to keep odd dimensions.\n"
        )
    sm, sn = kernel.shape
    tm, tn = target
    mr = (sm - tm) // 2 if sm > tm else 0
    mc = (sn - tn) // 2 if sn > tn else 0
    return kernel[mr : sm - mr, mc : sn - mc]


def resize_kernel(
    kernel,
    kernel_res=None,
    signal_res=None,
    factor=None,
    min_size=7,
    quiet=False,
):
    """Rescale a kernel to a new resolution via degree-1 spline zoom,
    forcing odd output dimensions.

    Reference: ``preprocessing.py:731-807``.
    """
    import scipy.ndimage as ndi

    km, kn = kernel.shape
    if km != kn:
        raise ValueError("kernel must be square.")
    if km % 2 == 0 or kn % 2 == 0:
        raise ValueError("kernel size must be odd.")
    if factor is not None and (
        kernel_res is not None or signal_res is not None
    ):
        raise ValueError(
            "pass either factor or the (kernel_res, signal_res) pair, "
            "not both"
        )
    if factor is None:
        if kernel_res is None or signal_res is None:
            raise ValueError(
                "resizing needs a factor, or both kernel_res and signal_res"
            )
        factor = kernel_res / signal_res
    # never shrink below min_size rows
    factor = max(factor, min_size / km)
    resized = ndi.zoom(kernel, factor, order=1)
    if resized.shape[0] % 2 == 0:
        # zoom landed on an even dimension: re-zoom one pixel smaller
        odd_factor = (resized.shape[0] - 1) / km
        if not quiet:
            sys.stderr.write(
                f"Adjusting resize factor from {factor} to {odd_factor}.\n"
            )
        resized = ndi.zoom(kernel, odd_factor, order=1)
    return resized


def factorise_kernel(kernel, prop_info=0.999):
    """Separable (truncated-SVD) form of a kernel.

    Keeps the smallest rank whose squared singular values cover
    ``prop_info`` of the total; each retained vector is scaled by
    sqrt(sigma) so ``left @ right`` reconstructs the kernel.  Numerics
    match reference ``preprocessing.py:810-847``.
    """
    u, sigma, vt = np.linalg.svd(kernel)
    energy = np.cumsum(sigma**2)
    rank = (
        int(np.searchsorted(energy, prop_info * energy[-1], side="right"))
        + 1
    )
    if rank > min(kernel.shape) // 2:
        sys.stderr.write(
            f"Warning: kernel factorisation kept {rank} singular vectors; "
            "the separable convolution path may be slow.\n"
        )
    scale = np.sqrt(sigma[:rank])
    return u[:, :rank] * scale, vt[:rank, :] * scale[:, None]


def subsample_contacts(M, n_contacts, rng=None):
    """Bootstrap-subsample ``n_contacts`` contacts, without replacement,
    from a scipy-sparse map, drawing from the ``RandomState`` ``rng``, by
    default from numpy's global state as the original does
    (``chromosight_tpu/preprocessing.py:290-309``: ``RandomState(s).choice``
    makes the draws of ``np.random.seed(s); np.random.choice``).  Contacts are enumerated
    through the cumulative counts and a uniform sample of contact indices
    is mapped back to matrix cells.  Returns a COO matrix.

    The picks of each cell are counted from the sorted picks (the picks
    below each cumulative count), which gives the original's
    ``bincount(searchsorted(cum_counts, picked, "right"))`` without its
    search in random order: ~10x less host time at 1e7 picks."""
    import scipy.sparse as sp

    M = M.tocoo()
    cum_counts = np.cumsum(M.data)
    tot_contacts = int(cum_counts[-1])
    picked = (np.random if rng is None else rng).choice(
        tot_contacts, size=int(n_contacts), replace=False
    )
    picked.sort()
    counts = np.diff(np.searchsorted(picked, cum_counts, side="left"), prepend=0)
    keep = counts > 0
    return sp.coo_matrix(
        (counts[keep].astype(np.float64), (M.row[keep], M.col[keep])),
        shape=M.shape,
    )
