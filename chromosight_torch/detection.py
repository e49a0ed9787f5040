"""Detection: Pearson on the device, foci and validation on the host.

Counterpart of ``chromosight_tpu/detection.py``.  ``pattern_detector``
dispatches on the map's form (``runtime.contact_map``) and on ``full``:

* band (intra maps with a scan distance), ``full=True``: one kernel or K
  same-shape kernels in one fused launch of the CUDA band Pearson, and
  quantify at given coordinates; the correlation maps stay on the device
  and only the candidates and the gathered scores and windows come back;
* band, ``full=False`` (valid mode): the map's O(nnz) sparse view through
  the sparse path below, as the JAX package routes it;
* dense (small inter maps, intra maps without a scan distance): the dense
  engine (``ops.normxcorr``), then the full-matrix foci and validation;
* sparse (trans maps above ``DENSE_LIMIT``): the tiled engine
  (``ops.tiled``), in full detect mode keeping only the candidates, then
  the sparse validation, which never densifies the map.

The public ``xcorr2`` and ``normxcorr2`` take numpy arrays, tensors or
scipy sparse matrices, as the reference's do.  The public functions take
and return the JAX package's pandas tables (bin1, bin2, score, pvalue);
the engines and the command line work on dicts of numpy columns.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from chromosight_torch import observability
from chromosight_torch.device import download, resolve_device, stage, upload
from chromosight_torch.ops.band import (
    at_cost,
    band_frame,
    band_normxcorr_at_packed,
    extract_candidates,
    gather_tail,
)
from chromosight_torch.ops.band_pearson import band_pearson
from chromosight_torch import native
from chromosight_torch.ops.convolve import xcorr2 as _xcorr2_dense
from chromosight_torch.ops.normxcorr import make_missing_mask_dense, normxcorr2_dense
from chromosight_torch.ops.preprocess import diag_trim_dense
from chromosight_torch.ops.tiled import normxcorr2_sparse_tiled, xcorr2_sparse_tiled
from chromosight_torch.preprocessing import (
    check_missing_mask,
    diag_trim,
    factorise_kernel,
    make_missing_mask,
    missing_flags,
)
from chromosight_torch.runtime import contact_map as _contact_map
from chromosight_torch.runtime.dump import save_matrix_snapshot, save_snapshot

# Above this many stored pixels the bulk point query of a CSR matrix
# groups queries by row instead of searching one flat key array.
POINT_QUERY_FLAT_NNZ = 1 << 22


def _sparse():
    import scipy.sparse as sp

    return sp


def _on_device(signal, device):
    """``signal`` (numpy array, tensor or scipy sparse matrix) as a
    float32 tensor on ``device`` (None: the tensor's own device, or the
    first CUDA card)."""
    if isinstance(signal, torch.Tensor):
        device = signal.device if device is None else device
    else:
        if _sparse().issparse(signal):
            signal = signal.toarray()
        return upload(np.asarray(signal, dtype=np.float32), resolve_device(device))
    return signal.to(device=resolve_device(device), dtype=torch.float32)


def _like_input(signal, out):
    """``out`` (a tensor) in the container type of ``signal``: a tensor,
    a numpy array, or a CSR matrix."""
    if isinstance(signal, torch.Tensor):
        return out
    out = download(out)
    return _sparse().csr_matrix(out) if _sparse().issparse(signal) else out


def xcorr2(signal, kernel, threshold=1e-4, tsvd=None, device=None):
    """Cross-correlation of a dense or sparse 2-D signal with a dense
    kernel, snapped below ``threshold`` and zero at the margins
    (``chromosight_tpu/detection.py:47-66``).  A sparse signal larger than
    ``DENSE_LIMIT`` on a side is scanned by the tiled engine and never
    densified.  Returns the input's container type."""
    if tsvd is not None:
        kernel = factorise_kernel(kernel, prop_info=tsvd)
    if _sparse().issparse(signal) and max(signal.shape) > _contact_map.DENSE_LIMIT:
        return xcorr2_sparse_tiled(
            signal, kernel, threshold=threshold, device=resolve_device(device)
        )
    return _like_input(signal, _xcorr2_dense(_on_device(signal, device), kernel, threshold))


def normxcorr2(
    signal,
    kernel,
    max_dist=None,
    sym_upper=False,
    full=False,
    missing_mask=None,
    missing_tol=0.75,
    tsvd=None,
    pval=False,
    device=None,
):
    """Sliding-window Pearson of a dense or sparse signal with a kernel
    (``chromosight_tpu/detection.py:69-152``): the dense engine, or for a
    sparse signal larger than ``DENSE_LIMIT`` on a side the tiled engine.
    Returns (corr, log10 p-values or None) in the input's container type;
    a sparse result holds p-values only where corr is non-zero."""
    sp = _sparse()
    is_sparse = sp.issparse(signal)
    if sp.issparse(kernel):
        raise ValueError("cannot handle kernel in sparse format")
    kernel = np.asarray(kernel)
    if not (kernel.std() > 0):
        raise ValueError("Cannot have flat kernel.")
    if missing_mask is not None:
        if is_sparse and not sp.issparse(missing_mask):
            raise ValueError("Missing mask must be a sparse matrix.")
        if tuple(signal.shape) != tuple(missing_mask.shape):
            raise ValueError("Signal and missing mask do not have the same shape")
        if missing_mask.dtype not in (bool, np.bool_, torch.bool):
            raise ValueError(f"Missing mask dtype is {missing_mask.dtype}. Should be bool.")
        if min(kernel.shape) >= max(signal.shape):
            raise ValueError("cannot have kernel bigger than signal")
        if not isinstance(missing_mask, torch.Tensor):
            check_missing_mask(signal, missing_mask)
    if is_sparse and max(signal.shape) > _contact_map.DENSE_LIMIT:
        return normxcorr2_sparse_tiled(
            signal,
            kernel,
            max_dist=max_dist,
            sym_upper=sym_upper,
            full=full,
            missing_mask=missing_mask,
            missing_tol=missing_tol,
            tsvd=tsvd,
            pval=pval,
            device=resolve_device(device),
        )
    dense = _on_device(signal, device)
    mask = None
    if missing_mask is not None:
        if sp.issparse(missing_mask):
            missing_mask = missing_mask.toarray()
        mask = torch.as_tensor(missing_mask).to(device=dense.device, dtype=torch.bool)
    corr, logp = normxcorr2_dense(
        dense,
        kernel,
        max_dist=max_dist,
        sym_upper=sym_upper,
        full=full,
        missing_mask=mask,
        missing_tol=missing_tol,
        tsvd=tsvd,
        pval=pval,
    )
    if is_sparse and logp is not None:
        logp = torch.where(corr != 0, logp, 0.0)
    return _like_input(signal, corr), (None if logp is None else _like_input(signal, logp))


def _connected_labels(rows, cols, n_cols):
    """4-way connected-component labels of a row-major sorted pixel list;
    each label is the index of its component's first pixel (the order
    scipy's connected_components gives the reference)."""
    n = len(rows)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    labels = native.cc_label(rows, cols, n_cols)
    if labels is not None:
        return labels
    flat = rows.astype(np.int64) * np.int64(n_cols) + cols.astype(np.int64)
    right = np.flatnonzero((np.diff(flat) == 1) & (np.diff(rows) == 0))
    below = flat + n_cols
    pos = np.searchsorted(flat, below)
    ok = pos < n
    ok[ok] = flat[pos[ok]] == below[ok]
    ea = np.concatenate([right, np.flatnonzero(ok)])
    eb = np.concatenate([right + 1, pos[ok]])
    lab = np.arange(n, dtype=np.int64)
    # min-label propagation with pointer jumping until a fixpoint
    while True:
        nxt = lab.copy()
        np.minimum.at(nxt, eb, lab[ea])
        np.minimum.at(nxt, ea, lab[eb])
        nxt = nxt[nxt]
        nxt = nxt[nxt]
        if np.array_equal(nxt, lab):
            return lab
        lab = nxt


def pileup_patterns(pattern_windows):
    """NaN-mean stack of pattern windows (reference ``detection.py:158-174``)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        return np.nanmean(pattern_windows, axis=0)


def remove_neighbours(patterns, win_size=8):
    """Boolean whitelist, in row order, of a pattern table (a DataFrame
    or a dict of columns with bin1, bin2, score) after greedy suppression
    of patterns closer than ``win_size`` on both axes, best scores first
    (NaN last, ties to the earlier row); reference ``detection.py:
    348-384``.  Rows count by position, whatever the table's index."""
    b1 = np.asarray(patterns["bin1"], dtype=np.int64)
    b2 = np.asarray(patterns["bin2"], dtype=np.int64)
    sc = np.asarray(patterns["score"], dtype=np.float64)
    keep = native.remove_neighbours(b1, b2, sc, win_size)
    if keep is not None:
        return keep
    return _remove_neighbours_numpy(b1, b2, sc, win_size)


def _remove_neighbours_numpy(b1, b2, sc, win_size):
    """Grid-hashed twin of the native sweep: same order and the same
    win_size-edged 3x3 cell neighbourhood."""
    n = len(b1)
    keep = np.ones(n, dtype=bool)
    if n == 0 or win_size <= 0:
        return keep
    order = np.lexsort((np.arange(n), -sc))
    nan_mask = np.isnan(sc[order])
    order = np.concatenate([order[~nan_mask], order[nan_mask]])
    w = int(win_size)
    c1, c2 = b1 // w, b2 // w
    cells = {}
    for i in range(n):
        cells.setdefault((c1[i], c2[i]), []).append(i)
    killed = np.zeros(n, dtype=bool)
    for i in order:
        if killed[i]:
            continue
        for d1 in (-1, 0, 1):
            for d2 in (-1, 0, 1):
                for j in cells.get((c1[i] + d1, c2[i] + d2), ()):
                    if j != i and abs(b1[j] - b1[i]) < w and abs(b2[j] - b2[i]) < w:
                        killed[j] = True
    keep[killed] = False
    return keep


def _validate_patterns_band(
    coords,
    band_shape,
    raw_windows,
    miss_flags,
    score_vec,
    kernel_matrix,
    big_k,
    drop=True,
    zero_tol=0.3,
    missing_tol=0.75,
):
    """Full-mode window validation in band space
    (``chromosight_tpu/detection.py:468-563``): the kh/kw zero padding,
    NaN missing rows/columns and NaN lower diagonals of the reference
    validation are applied analytically to the windows gathered on the
    device.  Returns (table, windows, valid mask): with ``drop`` (detect)
    the valid patterns only; without (quantify) every pattern, with NaN
    score and windows where invalid."""
    n, _ = band_shape
    win_h, win_w = kernel_matrix.shape
    kh, kw = (win_h - 1) // 2, (win_w - 1) // 2
    half_h, half_w = win_h // 2 + 1, win_w // 2 + 1
    coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
    p1, p2 = coords[:, 0], coords[:, 1]
    # padded coordinates: the reference pads the matrix by kh/kw
    high = p1 + kh - half_h + 1
    low = p1 + kh + half_h
    left = p2 + kw - half_w + 1
    right = p2 + kw + half_w
    # strict right < shape bound reproduced, not fixed (NOTES.md)
    inbound = (high >= 0) & (low < n + 2 * kh) & (left >= 0) & (right < n + 2 * kw)
    r = (high[:, None] - kh) + np.arange(win_h)[None, :]
    c = (left[:, None] - kw) + np.arange(win_w)[None, :]
    rr, cc = r[:, :, None], c[:, None, :]
    wins = np.array(raw_windows, dtype=np.float64, copy=True)
    dd = (rr + kh) - (cc + kw)
    wins = np.where((dd >= 1) & (dd <= big_k), np.nan, wins)
    row_missing = (r < 0) | (r >= n) | miss_flags[np.clip(r, 0, n - 1)]
    col_missing = (c < 0) | (c >= n) | miss_flags[np.clip(c, 0, n - 1)]
    wins = np.where(row_missing[:, :, None], np.nan, wins)
    wins = np.where(col_missing[:, None, :], np.nan, wins)
    tot = win_h * win_w
    n_missing = np.sum(~np.isfinite(wins), axis=(1, 2))
    n_zero = np.sum(wins == 0, axis=(1, 2))
    with np.errstate(invalid="ignore", divide="ignore"):
        prop_undetected = n_missing / tot
        prop_zero = n_zero / (tot - n_missing)
    valid = inbound & (prop_undetected < missing_tol) & (prop_zero < zero_tol)
    score = np.asarray(score_vec, dtype=np.float64)
    if drop:
        table = {"bin1": p1[valid], "bin2": p2[valid], "score": score[valid]}
        return table, wins[valid], valid
    table = {"bin1": p1, "bin2": p2, "score": np.where(valid, score, np.nan)}
    return table, np.where(valid[:, None, None], wins, np.nan), valid


def _band_guards(contact_map, kernel_matrix):
    """True when the map is smaller than the kernel (skip it).  Kernels
    taller than wide raise when the band holds signal on diagonals
    [0, km - kn), as the reference sparse engine does
    (``chromosight_tpu/detection.py:572-595``)."""
    km, kn = kernel_matrix.shape
    if min(contact_map.shape) <= max(kernel_matrix.shape):
        return True
    if km > kn:
        n_bad = int(torch.count_nonzero(contact_map.band_dev[:, : km - kn]))
        if n_bad:
            raise ValueError(
                f"There are {n_bad} non-zero elements reported as missing."
            )
    return False


def frame_contact_map(contact_map, kernel_shape):
    """The framed ``(sig_p, mask_p)`` that ``band_pearson`` reads for a
    created contact map and a kernel shape."""
    band = contact_map.band_dev
    n = contact_map.shape[0]
    miss = np.zeros(band.shape[0], dtype=bool)
    miss[:n] = missing_flags(contact_map.detectable_bins[0], n)
    return band_frame(
        band,
        torch.from_numpy(miss).to(band.device),
        kernel_shape,
        n,
        int(contact_map.max_dist),
    )


def _band_correlate(contact_map, kernel_config, kernels, tsvd=None):
    """(corr, log10p, cand) of one chromosome, on its device: framing
    then one ``band_pearson`` call.  ``kernels``: one (mk, nk) kernel, or
    a (K, mk, nk) stack of same-shape kernels for one fused launch, whose
    maps are then (K, n_pad, W)."""
    kernels = np.asarray(kernels)
    sig_p, mask_p = frame_contact_map(contact_map, kernels.shape[-2:])
    return band_pearson(
        sig_p,
        mask_p,
        kernels,
        contact_map.shape[0],
        int(contact_map.max_dist),
        kernel_config["max_perc_undetected"] / 100,
        float(kernel_config["pearson"]),
        tsvd=tsvd,
    )


def _dump_correlation(contact_map, corr, dump):
    """The 03 and 04 snapshots of ``--dump`` in the directory ``dump``:
    the band engine trims the diagonals inside the correlation, so both
    hold the trimmed map (``chromosight_tpu/detection.py:1058-1069``)."""
    n = contact_map.shape[0]
    corr = download(corr[:n]).astype(np.float64)
    i, d = np.nonzero(corr)
    for name in ("03_normxcorr2", "04_diag_trim"):
        save_snapshot(dump, contact_map.name, name, i, i + d, corr[i, d], n)


def _pick_foci(contact_map, corr, cand, dump):
    """Foci of the candidate pixels and the best pixel of each: exact
    extraction, 4-way labelling, foci of two pixels or more.  Returns the
    (n_foci, 2) matrix coordinates, or None; writes the 05 snapshot of
    ``--dump`` in ``dump`` (``chromosight_tpu/detection.py:1075-1150``)."""
    n = contact_map.shape[0]
    with stage("extract", corr.device):
        ii, dd, vals = extract_candidates(corr, cand)
        ci = download(ii).astype(np.int64)
        cd = download(dd).astype(np.int64)
        cv = download(vals).astype(np.float64)
    keep_c = (ci < n) & (ci + cd < n)
    ci, cd, cv = ci[keep_c], cd[keep_c], cv[keep_c]
    cj = ci + cd
    if len(ci) == 0:
        return None
    order = np.lexsort((cj, ci))
    ci, cj, cv = ci[order], cj[order], cv[order]
    lab = _connected_labels(ci, cj, n)
    uniq, inv, counts = np.unique(lab, return_inverse=True, return_counts=True)
    keep_focus = counts >= 2
    if not np.any(keep_focus):
        return None
    # best pixel per focus: max score, first row-major pixel on ties
    flat = ci * np.int64(n) + cj
    order2 = np.lexsort((flat, -cv, inv))
    first = np.searchsorted(inv[order2], np.arange(len(uniq)))
    best = order2[first][keep_focus]
    if dump is not None:
        px = keep_focus[inv]
        save_snapshot(dump, contact_map.name, "05_foci", ci[px], cj[px], inv[px] + 1, n)
    return np.stack([ci[best], cj[best]], axis=1).astype(np.int64)


def _band_tail(
    contact_map, kernel_config, kernel_matrix, corr, logp, cand, coords=None, dump=None
):
    """Host tail of band detection (``chromosight_tpu/detection.py:
    1032-1210``): foci picking (detect), or the given ``coords``
    (quantify), then the score/window gather and validation; the 03-05
    snapshots in ``dump``.  Returns (table, windows) or (None, None)."""
    km, kn = kernel_matrix.shape
    band = contact_map.band_dev
    device = band.device
    n = contact_map.shape[0]
    width = band.shape[1]
    miss_flags = missing_flags(contact_map.detectable_bins[0], n)
    detect_mode = coords is None
    if dump is not None:
        _dump_correlation(contact_map, corr, dump)
    if detect_mode:
        coords = _pick_foci(contact_map, corr, cand, dump)
        if coords is None:
            return None, None
    coords = np.array(coords, dtype=np.int64, copy=True).reshape(-1, 2)
    if kernel_config["max_dist"] == 0:
        coords[:, 0] = coords[:, 1]

    with stage("gather", device):
        p1 = torch.from_numpy(coords[:, 0]).to(device)
        dsc = torch.from_numpy(coords[:, 1] - coords[:, 0]).to(device)
        tail = gather_tail(corr, logp, band, p1, dsc, km, kn)
        tail = download(tail).astype(np.float64)
    n_pat = coords.shape[0]
    raw_windows = tail[:, 2:].reshape(n_pat, km, kn)
    dsc_h = coords[:, 1] - coords[:, 0]
    in_band = (coords[:, 0] >= 0) & (coords[:, 0] < n) & (dsc_h >= 0) & (dsc_h < width)
    score_vec = np.where(in_band, tail[:, 0], 0.0)
    logp_vec = np.where(in_band, tail[:, 1], np.nan)
    table, windows, valid = _validate_patterns_band(
        coords,
        (n, width),
        raw_windows,
        miss_flags,
        score_vec,
        kernel_matrix,
        big_k=max(km, kn),
        drop=detect_mode,
        zero_tol=kernel_config["max_perc_zero"] / 100,
        missing_tol=kernel_config["max_perc_undetected"] / 100,
    )
    table["pvalue"] = 10 ** (logp_vec[valid] if detect_mode else logp_vec)
    return table, windows


def quantify_banded(contact_map, kernel_config, kernels, coords, tsvd=None):
    """Score given coordinates with K same-shape kernels without the
    band sweep (``chromosight_tpu/detection.py:1329-1418``): one
    ``band_normxcorr_at_packed`` call gives every kernel's score and
    log10-p and the raw windows.  Returns one (table, windows) pair per
    kernel, every coordinate kept (NaN score where the window fails
    validation)."""
    kernels = np.stack([np.asarray(k) for k in kernels])
    n_k, km, kn = kernels.shape
    band = contact_map.band_dev
    device = band.device
    n = contact_map.shape[0]
    width = band.shape[1]
    coords = np.array(coords, dtype=np.int64, copy=True).reshape(-1, 2)
    if kernel_config["max_dist"] == 0:
        coords[:, 0] = coords[:, 1]
    n_pat = coords.shape[0]
    miss_flags = missing_flags(contact_map.detectable_bins[0], n)
    with stage("quantify-at", device):
        at_args = (
            band,
            torch.from_numpy(miss_flags).to(device),
            torch.from_numpy(coords[:, 0]).to(device),
            torch.from_numpy(coords[:, 1] - coords[:, 0]).to(device),
            kernels,
        )
        observability.account_dispatch("band_normxcorr_at", at_cost, *at_args)
        packed = band_normxcorr_at_packed(
            *at_args,
            n,
            int(contact_map.max_dist),
            kernel_config["max_perc_undetected"] / 100,
            tsvd=tsvd,
        )
        packed = download(packed).astype(np.float64)
    raw_windows = packed[:, 2 * n_k :].reshape(n_pat, km, kn)
    dsc = coords[:, 1] - coords[:, 0]
    in_band = (coords[:, 0] >= 0) & (coords[:, 0] < n) & (dsc >= 0) & (dsc < width)
    results = []
    for k in range(n_k):
        table, windows, _ = _validate_patterns_band(
            coords,
            (n, width),
            raw_windows,
            miss_flags,
            np.where(in_band, packed[:, k], 0.0),
            kernels[k],
            big_k=max(km, kn),
            drop=False,
            zero_tol=kernel_config["max_perc_zero"] / 100,
            missing_tol=kernel_config["max_perc_undetected"] / 100,
        )
        table["pvalue"] = 10 ** np.where(in_band, packed[:, n_k + k], np.nan)
        results.append((table, windows))
    return results


def fuse_kernels_eligible(kernels):
    """Whether a config's kernels run as one fused K-kernel launch: more
    than one kernel, all of one shape (``chromosight_tpu/detection.py:
    1242``, without its TPU switches)."""
    return len(kernels) > 1 and len({np.shape(k) for k in kernels}) == 1


def detect_banded_multi(
    contact_map, kernel_config, kernels, coords=None, dump=None, tsvd=None
):
    """Detect (or quantify) with every kernel of a config on one banded
    map in full mode (``chromosight_tpu/detection.py:1294-1326``): one
    ``band_pearson`` launch for the whole stack, in single-kernel mode for
    a stack of one.  With ``coords`` (an (n, 2) array of map bins) the
    given pixels are scored without the sweep, unless ``dump`` (the
    ``--dump`` directory) asks for the snapshots, as in the JAX package.
    Returns one (table with bin1/bin2/score/pvalue, window stack) pair per
    kernel, or (None, None) where the map is too small or nothing
    passes."""
    kernels = np.stack([np.asarray(k) for k in kernels])
    if _band_guards(contact_map, kernels[0]):
        return [(None, None)] * len(kernels)
    if coords is not None and dump is None:
        return quantify_banded(contact_map, kernel_config, kernels, coords, tsvd)
    with stage("correlate", contact_map.band_dev.device):
        if len(kernels) == 1:
            maps = _band_correlate(contact_map, kernel_config, kernels[0], tsvd)
            corr, logp, cand = (t[None] for t in maps)
        else:
            corr, logp, cand = _band_correlate(contact_map, kernel_config, kernels, tsvd)
    return [
        _band_tail(
            contact_map, kernel_config, kernels[k], corr[k], logp[k], cand[k], coords, dump
        )
        for k in range(len(kernels))
    ]


def _detect_one(contact_map, kernel_config, kernel_matrix, coords, dump, full, tsvd):
    """``pattern_detector`` with the table as a dict of numpy columns."""
    kernel_matrix = np.asarray(kernel_matrix)
    if contact_map.band_dev is not None and full:
        return detect_banded_multi(
            contact_map, kernel_config, [kernel_matrix], coords, dump, tsvd
        )[0]
    if contact_map.band_dev is not None or contact_map.sparse is not None:
        return _pattern_detector_sparse(
            contact_map, kernel_config, kernel_matrix, coords, dump, full, tsvd
        )
    return _pattern_detector_dense(
        contact_map, kernel_config, kernel_matrix, coords, dump, full, tsvd
    )


def pattern_detector(
    contact_map, kernel_config, kernel_matrix, coords=None, dump=None, full=False,
    tsvd=None,
):
    """Detect patterns of one kernel on a created contact map, or with
    ``coords`` (an (n, 2) array of map bins) score those pixels
    (``chromosight_tpu/detection.py:1424-1459``), on the map's device.

    ``full=True`` pads the map by the kernel's half-size (the
    command line's mode): the CUDA band Pearson on a band map, else the
    dense or tiled engine.  ``full=False`` (valid mode, the JAX package's
    default) scans only windows inside the map: a band map goes through
    its O(nnz) sparse view and the sparse path, a dense map through the
    dense engine.  ``dump`` is a directory for the 03-05 snapshots.

    Returns (DataFrame with bin1, bin2, score, pvalue; window stack), or
    (None, None) where the map is too small or nothing passes."""
    import pandas as pd

    table, windows = _detect_one(
        contact_map, kernel_config, kernel_matrix, coords, dump, full, tsvd
    )
    return (None, None) if table is None else (pd.DataFrame(table), windows)


def detect_multi(contact_map, kernel_config, kernels, coords=None, dump=None, tsvd=None):
    """Every kernel of a config on one map in full mode: one fused band
    launch for a band map (``detect_banded_multi``), one full-mode
    ``pattern_detector`` pass per kernel otherwise
    (``chromosight_tpu/cli/main.py:455-466, 522-537``).  One (table,
    windows) pair per kernel, the tables as dicts of numpy columns."""
    if contact_map.band_dev is not None:
        return detect_banded_multi(contact_map, kernel_config, kernels, coords, dump, tsvd)
    return [
        _detect_one(contact_map, kernel_config, k, coords, dump, True, tsvd)
        for k in kernels
    ]


# ------------------------------------------------------------------ #
# Full-matrix foci and validation (dense and sparse maps)
# ------------------------------------------------------------------ #
def label_foci(matrix):
    """1-based labels of the 4-way connected foci of the non-zero pixels
    of a matrix, ordered by each focus' first row-major pixel
    (``chromosight_tpu/detection.py:207-223``): (number of foci, COO
    matrix of labels)."""
    sp = _sparse()
    coo = sp.coo_matrix(sp.csr_matrix(matrix))
    order = np.lexsort((coo.col, coo.row))
    rows, cols = coo.row[order], coo.col[order]
    lab = _connected_labels(rows, cols, matrix.shape[1])
    uniq, inv = np.unique(lab, return_inverse=True)
    return len(uniq), sp.coo_matrix((inv + 1, (rows, cols)), shape=matrix.shape)


def filter_foci(foci_mat, min_size=2):
    """Foci of fewer than ``min_size`` pixels dropped, labels kept
    (``chromosight_tpu/detection.py:226-243``): (number kept, COO)."""
    data = foci_mat.data.copy()
    ids, sizes = np.unique(data, return_counts=True)
    small = ids[sizes < min_size]
    if len(small):
        data[np.isin(data, small)] = 0
    filtered = _sparse().coo_matrix(
        (data, (foci_mat.row, foci_mat.col)), shape=foci_mat.shape
    )
    filtered.eliminate_zeros()
    return int(np.sum(sizes >= min_size)), filtered


def pick_foci(mat_conv, pearson, min_size=2):
    """The best pixel of each focus of at least ``min_size`` 4-connected
    pixels >= ``pearson`` (and non-zero), ties to the first row-major
    pixel, and the COO matrix of the kept foci's labels
    (``chromosight_tpu/detection.py:246-291``): ``mat_conv`` a scipy
    sparse matrix or a dense array.  (None, None) when there is none."""
    sp = _sparse()
    if sp.issparse(mat_conv):
        coo = mat_conv.tocoo()
        cand = (coo.data >= pearson) & (coo.data != 0)
        rows, cols, scores = coo.row[cand], coo.col[cand], coo.data[cand]
        order = np.lexsort((cols, rows))
        rows, cols, scores = rows[order], cols[order], scores[order]
    else:
        dense = np.asarray(mat_conv)
        rows, cols = np.nonzero((dense >= pearson) & (dense != 0))
        scores = dense[rows, cols]
    n_cols = mat_conv.shape[1]
    if len(rows) == 0:
        return None, None
    lab = _connected_labels(rows, cols, n_cols)
    uniq, inv, counts = np.unique(lab, return_inverse=True, return_counts=True)
    keep_focus = counts >= min_size
    if not np.any(keep_focus):
        return None, None
    keep_px = keep_focus[inv]
    labelled = sp.coo_matrix(
        (inv[keep_px] + 1, (rows[keep_px], cols[keep_px])), shape=mat_conv.shape
    )
    flat = rows.astype(np.int64) * np.int64(n_cols) + cols
    order = np.lexsort((flat, -scores, inv))
    first = np.searchsorted(inv[order], np.arange(len(uniq)))
    best = order[first][keep_focus]
    return np.stack([rows[best], cols[best]], axis=1).astype(np.int64), labelled


def _window_table(coords, valid, scores, windows, drop):
    """(table, windows): the valid patterns only with ``drop``, else every
    pattern with NaN score and windows where invalid."""
    table = {
        "bin1": coords[:, 0].copy(),
        "bin2": coords[:, 1].copy(),
        "score": np.where(valid, scores, np.nan),
    }
    windows = np.where(valid[:, None, None], windows, np.nan)
    if drop:
        return {k: v[valid] for k, v in table.items()}, windows[valid]
    return table, windows


def _window_validity(wins, tot, zero_tol, missing_tol):
    n_missing = np.sum(~np.isfinite(wins), axis=(1, 2))
    n_zero = np.sum(wins == 0, axis=(1, 2))
    with np.errstate(invalid="ignore", divide="ignore"):
        prop_undetected = n_missing / tot
        prop_zero = n_zero / (tot - n_missing)
    return (prop_undetected < missing_tol) & (prop_zero < zero_tol)


def _validate_dense(
    coords, matrix, conv_mat, detectable_bins, kernel_matrix, zero_tol, missing_tol
):
    """Window validation on dense host arrays: every candidate's window,
    NaN on missing rows and columns, rejected when out of bounds (the
    reference's strict last-row bound kept) or with too many missing or
    zero pixels.  Returns (coords, valid, scores, windows), every pattern
    kept."""
    mat = np.asarray(matrix, dtype=np.float64)
    conv = np.asarray(conv_mat, dtype=np.float64)
    coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
    win_h, win_w = kernel_matrix.shape
    half_h, half_w = win_h // 2 + 1, win_w // 2 + 1
    miss_rows = missing_flags(detectable_bins[0], mat.shape[0])
    miss_cols = missing_flags(detectable_bins[1], mat.shape[1])
    p1, p2 = coords[:, 0], coords[:, 1]
    high, left = p1 - half_h + 1, p2 - half_w + 1
    inbound = (
        (high >= 0) & (p1 + half_h < mat.shape[0])
        & (left >= 0) & (p2 + half_w < mat.shape[1])
    )
    ridx = np.clip(high[:, None] + np.arange(win_h)[None, :], 0, mat.shape[0] - 1)
    cidx = np.clip(left[:, None] + np.arange(win_w)[None, :], 0, mat.shape[1] - 1)
    wins = mat[ridx[:, :, None], cidx[:, None, :]]
    wins = np.where(miss_rows[ridx][:, :, None], np.nan, wins)
    wins = np.where(miss_cols[cidx][:, None, :], np.nan, wins)
    valid = inbound & _window_validity(wins, win_h * win_w, zero_tol, missing_tol)
    scores = conv[np.clip(p1, 0, conv.shape[0] - 1), np.clip(p2, 0, conv.shape[1] - 1)]
    return coords, valid, scores, wins


def validate_patterns(
    coords, matrix, conv_mat, detectable_bins, kernel_matrix, drop=True,
    zero_tol=0.3, missing_tol=0.75,
):
    """Filter detected patterns by window quality and extract their
    windows (``chromosight_tpu/detection.py:297-390``): ``matrix`` and
    ``conv_mat`` dense arrays or scipy sparse matrices (densified).
    Returns (DataFrame with bin1/bin2/score, windows): with ``drop`` the
    valid rows only (their labels kept), else every row, with NaN score
    and windows where invalid."""
    import pandas as pd

    sp = _sparse()
    matrix = matrix.toarray() if sp.issparse(matrix) else matrix
    conv_mat = conv_mat.toarray() if sp.issparse(conv_mat) else conv_mat
    coords, valid, scores, wins = _validate_dense(
        coords, matrix, conv_mat, detectable_bins, kernel_matrix, zero_tol, missing_tol
    )
    table, wins = _window_table(coords, valid, scores, wins, drop=False)
    table = pd.DataFrame(table)
    return (table.loc[valid, :], wins[valid]) if drop else (table, wins)


def _csr_point_values(csr, qr, qc):
    """Bulk point query csr[qr[k], qc[k]] (0 where absent or out of
    range): one search over the row-major flat keys, or for large
    matrices one search per queried row's segment, so the transient
    memory stays O(queries) (``chromosight_tpu/detection.py:1579-1631``)."""
    if csr.nnz == 0 or len(qr) == 0:
        return np.zeros(len(qr), dtype=np.float64)
    csr = csr.tocsr()
    csr.sum_duplicates()
    qr = np.asarray(qr, dtype=np.int64)
    qc = np.asarray(qc, dtype=np.int64)
    valid = (qr >= 0) & (qr < csr.shape[0]) & (qc >= 0) & (qc < csr.shape[1])
    if not valid.all():
        out = np.zeros(len(qr), dtype=np.float64)
        out[valid] = _csr_point_values(csr, qr[valid], qc[valid])
        return out
    if csr.nnz <= POINT_QUERY_FLAT_NNZ:
        ncols = np.int64(csr.shape[1])
        rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr))
        flat = rows * ncols + csr.indices
        q = qr * ncols + qc
        pos = np.minimum(np.searchsorted(flat, q), len(flat) - 1)
        return np.where(flat[pos] == q, csr.data[pos], 0.0).astype(np.float64)
    out = np.zeros(len(qr), dtype=np.float64)
    order = np.lexsort((qc, qr))
    qr_s, qc_s = qr[order], qc[order]
    starts = np.flatnonzero(np.r_[True, qr_s[1:] != qr_s[:-1]])
    bounds = np.r_[starts, len(qr_s)]
    for k in range(len(starts)):
        s, e = bounds[k], bounds[k + 1]
        lo, hi = csr.indptr[qr_s[s]], csr.indptr[qr_s[s] + 1]
        if lo == hi:
            continue
        seg = csr.indices[lo:hi]
        pos = np.minimum(np.searchsorted(seg, qc_s[s:e]), hi - lo - 1)
        out[order[s:e]] = np.where(seg[pos] == qc_s[s:e], csr.data[lo + pos], 0.0)
    return out


def _validate_patterns_sparse(
    coords, matrix, conv_mat, detectable_bins, kernel_matrix, drop=True,
    zero_tol=0.3, missing_tol=0.75, nan_band=0, pad=None,
):
    """``validate_patterns`` with sparse window reads: the matrix is never
    densified (``chromosight_tpu/detection.py:1634-1811``).  ``nan_band``
    NaNs the window pixels on diagonals 1..nan_band below the main one;
    ``pad=(kh, kw)`` gives full-mode semantics without padded copies:
    ``coords`` and ``detectable_bins`` are in padded coordinates, reads
    subtract the offset, and pixels in the margins read 0.

    Phase 1 (more than 64 patterns, no ``nan_band``) drops candidates
    without reading values: the missing count of an in-bound window is
    exactly (wh * ww) - (wh - missing rows)(ww - missing cols), and its
    stored non-zero count bounds its non-zero pixels from above.  Phase 2
    reads the survivors' windows and validates them exactly."""
    matrix = matrix.tocsr()
    conv = conv_mat.tocsr()
    coords = np.asarray(coords, dtype=np.int64).reshape(-1, 2)
    n_pat = coords.shape[0]
    win_h, win_w = kernel_matrix.shape
    half_h, half_w = win_h // 2 + 1, win_w // 2 + 1
    kh, kw = pad if pad is not None else (0, 0)
    shape = (matrix.shape[0] + 2 * kh, matrix.shape[1] + 2 * kw)
    miss_rows = missing_flags(detectable_bins[0], shape[0])
    miss_cols = missing_flags(detectable_bins[1], shape[1])
    windows = np.full((n_pat, win_h, win_w), np.nan)
    scores = np.full(n_pat, np.nan)
    valid = np.zeros(n_pat, dtype=bool)
    if n_pat:
        p1, p2 = coords[:, 0], coords[:, 1]
        high, left = p1 - half_h + 1, p2 - half_w + 1
        inbound = (
            (high >= 0) & (p1 + half_h < shape[0]) & (left >= 0) & (p2 + half_w < shape[1])
        )
        tot = win_h * win_w
        cand = inbound.copy()
        if nan_band == 0 and n_pat > 64:
            rpre = np.zeros(shape[0] + 1)
            rpre[1:] = np.cumsum(miss_rows)
            cpre = np.zeros(shape[1] + 1)
            cpre[1:] = np.cumsum(miss_cols)
            hi_c = np.clip(high, 0, shape[0] - win_h)
            lf_c = np.clip(left, 0, shape[1] - win_w)
            mr = rpre[hi_c + win_h] - rpre[hi_c]
            mc = cpre[lf_c + win_w] - cpre[lf_c]
            n_miss_a = tot - (win_h - mr) * (win_w - mc)
            with np.errstate(invalid="ignore", divide="ignore"):
                cand &= (n_miss_a / tot) < missing_tol
            nzrows = np.repeat(
                np.arange(matrix.shape[0], dtype=np.int64), np.diff(matrix.indptr)
            )
            nzsel = matrix.data != 0
            ncols = np.int64(matrix.shape[1])
            nzflat = nzrows[nzsel] * ncols + matrix.indices[nzsel]
            ci = np.flatnonzero(cand)
            if len(ci):
                ru0 = (hi_c[ci, None] + np.arange(win_h, dtype=np.int64)[None, :]) - kh
                ok_r = (ru0 >= 0) & (ru0 < matrix.shape[0])
                c_lo = np.clip(lf_c[ci] - kw, 0, matrix.shape[1])
                c_hi = np.clip(lf_c[ci] - kw + win_w, 0, matrix.shape[1])
                cnt = np.searchsorted(nzflat, ru0 * ncols + c_hi[:, None]) - np.searchsorted(
                    nzflat, ru0 * ncols + c_lo[:, None]
                )
                cnt = np.where(ok_r, cnt, 0).sum(axis=1)
                cand[ci] &= cnt > (1 - zero_tol) * (tot - n_miss_a[ci]) - 1e-9
        survivors = np.flatnonzero(cand)
        n_s = len(survivors)
        ridx = np.clip(high[survivors, None] + np.arange(win_h)[None, :], 0, shape[0] - 1)
        cidx = np.clip(left[survivors, None] + np.arange(win_w)[None, :], 0, shape[1] - 1)
        rr = np.broadcast_to(ridx[:, :, None], (n_s, win_h, win_w))
        cc = np.broadcast_to(cidx[:, None, :], (n_s, win_h, win_w))
        ru, cu = rr.ravel() - kh, cc.ravel() - kw
        ok = (ru >= 0) & (ru < matrix.shape[0]) & (cu >= 0) & (cu < matrix.shape[1])
        wins = np.zeros(n_s * win_h * win_w)
        if ok.any():
            wins[ok] = _csr_point_values(matrix, ru[ok], cu[ok])
        wins = wins.reshape(n_s, win_h, win_w)
        wins = np.where(miss_rows[ridx][:, :, None], np.nan, wins)
        wins = np.where(miss_cols[cidx][:, None, :], np.nan, wins)
        if nan_band:
            d = rr - cc
            wins = np.where((d >= 1) & (d <= nan_band), np.nan, wins)
        valid_s = inbound[survivors] & _window_validity(wins, tot, zero_tol, missing_tol)
        valid[survivors] = valid_s
        if valid_s.any():
            sv = survivors[valid_s]
            scores[sv] = _csr_point_values(
                conv,
                np.clip(p1[sv] - kh, 0, conv.shape[0] - 1),
                np.clip(p2[sv] - kw, 0, conv.shape[1] - 1),
            )
            windows[sv] = wins[valid_s]
    return _window_table(coords, valid, scores, windows, drop)


def _pvalues(logp_at, b1, b2, shape):
    """10^log10p at the table's bins, NaN out of the map."""
    inb = (b1 >= 0) & (b1 < shape[0]) & (b2 >= 0) & (b2 < shape[1])
    lp = np.full(len(b1), np.nan)
    if inb.any():
        lp[inb] = logp_at(b1[inb], b2[inb])
    return 10**lp


def _pattern_detector_dense(
    contact_map, kernel_config, kernel_matrix, coords, dump, full, tsvd
):
    """Detection on a dense map on the device (``chromosight_tpu/
    detection.py:1461-1568``): the dense engine, in ``full`` mode with the
    crossing (inter) or upper-symmetric (intra) missing mask, the
    diagonal trim of intra maps, then foci and validation on the host
    (full mode: with the windows' kernel-sized zero padding); ``dump``
    snapshots 03-05."""
    mat_dev = contact_map.dense_dev
    n1, n2 = mat_dev.shape
    if min(n1, n2) <= max(kernel_matrix.shape):
        return None, None
    km, kn = kernel_matrix.shape
    kh, kw = ((km - 1) // 2, (kn - 1) // 2) if full else (0, 0)
    inter = contact_map.inter
    dev = mat_dev.device
    det = contact_map.detectable_bins
    with stage("correlate", dev):
        mask = None
        if full:
            miss_r = torch.from_numpy(missing_flags(det[0], n1)).to(dev)
            miss_c = torch.from_numpy(missing_flags(det[1], n2)).to(dev)
            mask = make_missing_mask_dense(
                (n1, n2), miss_r, miss_c, max_dist=contact_map.max_dist,
                sym_upper=not inter,
            )
        corr, logp = normxcorr2_dense(
            mat_dev,
            kernel_matrix,
            max_dist=contact_map.max_dist,
            sym_upper=not inter,
            full=full,
            missing_mask=mask,
            tsvd=tsvd,
            pval=True,
            missing_tol=kernel_config["max_perc_undetected"] / 100,
        )
        del mask
        if dump is not None:
            save_matrix_snapshot(dump, contact_map.name, "03_normxcorr2", download(corr))
        if not inter:
            corr = diag_trim_dense(corr, contact_map.max_dist)
            if dump is not None:
                save_matrix_snapshot(dump, contact_map.name, "04_diag_trim", download(corr))
        mat_conv = download(corr).astype(np.float64)
        mat_conv[np.isnan(mat_conv)] = 0
        logp = download(logp).astype(np.float64)
    if coords is None:
        with stage("host: foci", dev):
            coords, foci_mat = pick_foci(mat_conv, kernel_config["pearson"])
        if coords is None:
            return None, None
        if dump is not None:
            save_matrix_snapshot(dump, contact_map.name, "05_foci", foci_mat.toarray())
        drop = True
    else:
        drop = False
    coords = np.array(coords, dtype=np.int64, copy=True).reshape(-1, 2)
    with stage("host: validate", dev):
        mat = np.pad(download(mat_dev.double()), ((kh, kh), (kw, kw)))
        mat_conv = np.pad(mat_conv, ((kh, kh), (kw, kw)))
        det = [np.asarray(det[0]) + kh, np.asarray(det[1]) + kw]
        coords += (kh, kw)
        if not inter:
            i, j = np.indices(mat.shape, sparse=True)
            mat = np.where((i - j >= 1) & (i - j <= max(km, kn)), np.nan, mat)
            if kernel_config["max_dist"] == 0:
                coords[:, 0] = coords[:, 1]
        table, windows = _window_table(
            *_validate_dense(
                coords, mat, mat_conv, det, kernel_matrix,
                zero_tol=kernel_config["max_perc_zero"] / 100,
                missing_tol=kernel_config["max_perc_undetected"] / 100,
            ),
            drop=drop,
        )
    table["bin1"] -= kh
    table["bin2"] -= kw
    table["pvalue"] = _pvalues(
        lambda r, c: logp[r, c], table["bin1"], table["bin2"], logp.shape
    )
    return table, windows


def _pattern_detector_sparse(
    contact_map, kernel_config, kernel_matrix, coords, dump, full, tsvd
):
    """Detection on a sparse map, or on the O(nnz) sparse view of a band
    map (``chromosight_tpu/detection.py:1814-1953``).  Full mode on an
    inter map: the tiled engine with the missing bins as two vectors (in
    detect mode keeping only coefficients >= pearson, unless ``dump``
    wants the whole map), its batches spread over the run's devices.
    Otherwise the public ``normxcorr2`` (the dense engine up to
    ``DENSE_LIMIT`` bins a side, the tiled one above), with the
    upper-symmetric missing mask in full mode and none in valid mode.
    Then foci and the two-phase sparse validation on the host, with
    virtual padding in full mode."""
    source = contact_map.sparse if contact_map.sparse is not None else contact_map.matrix
    smat = source.tocsr()
    km, kn = kernel_matrix.shape
    if min(smat.shape) <= max(kernel_matrix.shape):
        return None, None
    kh, kw = ((km - 1) // 2, (kn - 1) // 2) if full else (0, 0)
    inter = contact_map.inter
    dev = contact_map.device
    det = contact_map.detectable_bins
    missing_tol = kernel_config["max_perc_undetected"] / 100
    if full and inter:
        keep_min = None
        if coords is None and dump is None and float(kernel_config["pearson"]) > 0:
            keep_min = float(kernel_config["pearson"])
        corr, logp = normxcorr2_sparse_tiled(
            smat,
            kernel_matrix,
            full=True,
            missing_vectors=(
                missing_flags(det[0], smat.shape[0]),
                missing_flags(det[1], smat.shape[1]),
            ),
            missing_tol=missing_tol,
            tsvd=tsvd,
            pval=True,
            keep_min=keep_min,
            device=contact_map.devices,
        )
    else:
        mask = None
        if full:
            mask = make_missing_mask(
                smat.shape, det[0], det[1], max_dist=contact_map.max_dist,
                sym_upper=not inter,
            )
        corr, logp = normxcorr2(
            smat, kernel_matrix, max_dist=contact_map.max_dist, sym_upper=not inter,
            full=full, missing_mask=mask, missing_tol=missing_tol, tsvd=tsvd,
            pval=True, device=dev,
        )
    corr = corr.tocsr()
    if dump is not None:
        save_matrix_snapshot(dump, contact_map.name, "03_normxcorr2", corr)
    if not inter:
        corr = diag_trim(corr, contact_map.max_dist)
        if dump is not None:
            save_matrix_snapshot(dump, contact_map.name, "04_diag_trim", corr)
    drop = coords is None
    if drop:
        with stage("host: foci", dev):
            coords, foci_mat = pick_foci(corr, kernel_config["pearson"])
        if coords is None:
            return None, None
        if dump is not None:
            save_matrix_snapshot(dump, contact_map.name, "05_foci", foci_mat)
    coords = np.array(coords, dtype=np.int64, copy=True).reshape(-1, 2) + (kh, kw)
    with stage("host: validate", dev):
        det = [np.asarray(det[0]) + kh, np.asarray(det[1]) + kw]
        if not inter and kernel_config["max_dist"] == 0:
            coords[:, 0] = coords[:, 1]
        table, windows = _validate_patterns_sparse(
            coords, smat, corr, det, kernel_matrix, drop=drop,
            zero_tol=kernel_config["max_perc_zero"] / 100,
            missing_tol=missing_tol,
            nan_band=0 if inter else max(km, kn),
            pad=(kh, kw) if full else None,
        )
    table["bin1"] -= kh
    table["bin2"] -= kw
    logp = logp.tocsr()
    table["pvalue"] = _pvalues(
        lambda r, c: _csr_point_values(logp, r, c), table["bin1"], table["bin2"], logp.shape
    )
    return table, windows
