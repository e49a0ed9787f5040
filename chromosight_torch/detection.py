"""Band-engine detection: Pearson on the device, foci and validation on host.

Counterpart of ``chromosight_tpu/detection.py``, band path only: detect
with one kernel or with K same-shape kernels in one fused launch, and
quantify at given coordinates.  The correlation maps stay on the device;
only the candidate pixels and the gathered scores and windows come back
to the host.  Pattern tables are dicts of numpy columns (bin1, bin2,
score, pvalue).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from chromosight_torch.device import stage
from chromosight_torch.ops.band import (
    band_frame,
    band_normxcorr_at_packed,
    extract_candidates,
    gather_tail,
)
from chromosight_torch.ops.band_pearson import band_pearson
from chromosight_torch import native
from chromosight_torch.preprocessing import missing_flags
from chromosight_torch.runtime.dump import save_snapshot


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


def remove_neighbours(bin1, bin2, score, win_size=8):
    """Whitelist after greedy suppression of patterns closer than
    ``win_size`` on both axes, best scores first (NaN last, ties to the
    earlier row); reference ``detection.py:348-384``."""
    b1 = np.asarray(bin1, dtype=np.int64)
    b2 = np.asarray(bin2, dtype=np.int64)
    sc = np.asarray(score, dtype=np.float64)
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
        n_bad = int(torch.count_nonzero(contact_map.band[:, : km - kn]))
        if n_bad:
            raise ValueError(
                f"There are {n_bad} non-zero elements reported as missing."
            )
    return False


def frame_contact_map(contact_map, kernel_shape):
    """The framed ``(sig_p, mask_p)`` that ``band_pearson`` reads for a
    created contact map and a kernel shape."""
    band = contact_map.band
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


def _dump_correlation(contact_map, corr):
    """The 03 and 04 snapshots of ``--dump``: the band engine trims the
    diagonals inside the correlation, so both hold the trimmed map
    (``chromosight_tpu/detection.py:1058-1069``)."""
    n = contact_map.shape[0]
    corr = corr[:n].double().cpu().numpy()
    i, d = np.nonzero(corr)
    for name in ("03_normxcorr2", "04_diag_trim"):
        save_snapshot(contact_map.dump, contact_map.name, name, i, i + d, corr[i, d], n)


def _pick_foci(contact_map, corr, cand):
    """Foci of the candidate pixels and the best pixel of each: exact
    extraction, 4-way labelling, foci of two pixels or more.  Returns the
    (n_foci, 2) matrix coordinates, or None; writes the 05 snapshot of
    ``--dump`` (``chromosight_tpu/detection.py:1075-1150``)."""
    n = contact_map.shape[0]
    with stage("extract", corr.device):
        ii, dd, vals = extract_candidates(corr, cand)
        ci = ii.cpu().numpy().astype(np.int64)
        cd = dd.cpu().numpy().astype(np.int64)
        cv = vals.cpu().numpy().astype(np.float64)
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
    if contact_map.dump is not None:
        px = keep_focus[inv]
        save_snapshot(
            contact_map.dump, contact_map.name, "05_foci", ci[px], cj[px], inv[px] + 1, n
        )
    return np.stack([ci[best], cj[best]], axis=1).astype(np.int64)


def _band_tail(contact_map, kernel_config, kernel_matrix, corr, logp, cand, coords=None):
    """Host tail of band detection (``chromosight_tpu/detection.py:
    1032-1210``): foci picking (detect), or the given ``coords``
    (quantify), then the score/window gather and validation.  Returns
    (table, windows) or (None, None)."""
    km, kn = kernel_matrix.shape
    band = contact_map.band
    device = band.device
    n = contact_map.shape[0]
    width = band.shape[1]
    miss_flags = missing_flags(contact_map.detectable_bins[0], n)
    detect_mode = coords is None
    if contact_map.dump is not None:
        _dump_correlation(contact_map, corr)
    if detect_mode:
        coords = _pick_foci(contact_map, corr, cand)
        if coords is None:
            return None, None
    coords = np.array(coords, dtype=np.int64, copy=True).reshape(-1, 2)
    if kernel_config["max_dist"] == 0:
        coords[:, 0] = coords[:, 1]

    with stage("gather", device):
        p1 = torch.from_numpy(coords[:, 0]).to(device)
        dsc = torch.from_numpy(coords[:, 1] - coords[:, 0]).to(device)
        tail = gather_tail(corr, logp, band, p1, dsc, km, kn)
        tail = tail.cpu().numpy().astype(np.float64)
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
    band = contact_map.band
    device = band.device
    n = contact_map.shape[0]
    width = band.shape[1]
    coords = np.array(coords, dtype=np.int64, copy=True).reshape(-1, 2)
    if kernel_config["max_dist"] == 0:
        coords[:, 0] = coords[:, 1]
    n_pat = coords.shape[0]
    miss_flags = missing_flags(contact_map.detectable_bins[0], n)
    with stage("quantify-at", device):
        packed = band_normxcorr_at_packed(
            band,
            torch.from_numpy(miss_flags).to(device),
            torch.from_numpy(coords[:, 0]).to(device),
            torch.from_numpy(coords[:, 1] - coords[:, 0]).to(device),
            kernels,
            n,
            int(contact_map.max_dist),
            kernel_config["max_perc_undetected"] / 100,
            tsvd=tsvd,
        )
        packed = packed.cpu().numpy().astype(np.float64)
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
    contact_map, kernel_config, kernels, coords=None, tsvd=None
):
    """Detect (or quantify) with every kernel of a config on one banded
    map (``chromosight_tpu/detection.py:1294-1326``): one ``band_pearson``
    launch for the whole stack, in single-kernel mode for a stack of one.
    With ``coords`` (an (n, 2) array of map bins) the given pixels are
    scored without the sweep, unless ``--dump`` (the map's ``dump``
    directory) asks for the snapshots, as in the JAX package.  Returns one
    (table with bin1/bin2/score/pvalue, window stack) pair per kernel, or
    (None, None) where the map is too small or nothing passes."""
    kernels = np.stack([np.asarray(k) for k in kernels])
    if _band_guards(contact_map, kernels[0]):
        return [(None, None)] * len(kernels)
    if coords is not None and contact_map.dump is None:
        return quantify_banded(contact_map, kernel_config, kernels, coords, tsvd)
    with stage("correlate", contact_map.band.device):
        if len(kernels) == 1:
            maps = _band_correlate(contact_map, kernel_config, kernels[0], tsvd)
            corr, logp, cand = (t[None] for t in maps)
        else:
            corr, logp, cand = _band_correlate(contact_map, kernel_config, kernels, tsvd)
    return [
        _band_tail(
            contact_map, kernel_config, kernels[k], corr[k], logp[k], cand[k], coords
        )
        for k in range(len(kernels))
    ]


def pattern_detector(contact_map, kernel_config, kernel_matrix, coords=None, tsvd=None):
    """``detect_banded_multi`` for one kernel
    (``chromosight_tpu/detection.py:1424-1451``, band branch): its
    (table, windows) pair."""
    return detect_banded_multi(
        contact_map, kernel_config, [kernel_matrix], coords, tsvd
    )[0]
