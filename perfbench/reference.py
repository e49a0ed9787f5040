"""The plain reference of ``detect``: chromosight's semantics in plain torch.

It reads only what the benchmark made (``genome.Genome``: the count
bands, the trans pixels and the ICE weights) and the pattern's kernels
from ``patterns/<name>.json`` (frozen copies of chromosight's presets),
and computes in one ``dtype`` throughout: float64 as chromosight does.
The lower-precision control computes one step below what the
configuration states: the Pearson in float32 (float64 stated) and the
preprocessed maps, whose values the windows hold, in bfloat16 (float32
stated).  Nothing of the program is imported.

Intra-chromosomal maps (the band of chromosight's full mode, reference
``detection.py`` / ``preprocessing.py`` / ``contacts_map.py``):

1. balance: ``count * w[i] * w[j]`` at the stored pixels of the upper
   band of ``keep_distance + 1`` diagonals (scan distance plus the largest
   kernel), NaN where a bin has no weight;
2. detrend: each diagonal divided by the mean of its positive pixels
   between two detectable bins (over the first ``keep_distance + 1``),
   values >= 10 reset to 1, NaN to 0;
3. the missing-corrected Pearson of each kernel in full mode: the map
   padded by the kernel's half size, the missing mask (missing rows and
   columns within the scan distance, the ``largest kernel`` diagonals
   below the main one, the frame) and six window sums, each snapped to 0
   below 1e-4, then the Pearson algebra and the Fisher-z log10 p-value;
   corr kept within the scan distance;
4. foci: 4-connected pixels with corr >= ``pearson``, foci of two pixels
   or more, the best pixel of each (ties to the first row-major pixel);
   on a diagonal pattern (``max_dist`` 0) the row set to the column;
5. windows around each pixel, NaN on missing rows and columns and the
   diagonals below the main one, rejected when too many pixels are
   missing or zero.

Inter-chromosomal maps (``--inter``) are scanned whole: the map divided
by the median of its stored pixels, the Pearson evaluated at every pixel
whose window holds a contact (all others have corr 0), then steps 4 and
5 without the diagonal rules.

Then, over all maps (reference cli:805-867): the calls of every kernel
stacked kernel-major, greedy suppression of calls closer than
``min_separation`` on both axes (best score first, NaN last, ties to the
earlier row), the ``min_dist`` and NaN p-value filters and
Benjamini-Hochberg q-values.
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np
import torch

PATTERN_DIR = pathlib.Path(__file__).parent / "patterns"
SNAP = 1e-4
# elements of a plane of window sums computed at once
BLOCK_ELEMENTS = 1 << 22


def load_pattern(name):
    """The pattern configuration ``patterns/<name>.json``, its kernels as
    float64 arrays."""
    cfg = json.loads((PATTERN_DIR / f"{name}.json").read_text())
    cfg["kernels"] = [np.asarray(k, dtype=np.float64) for k in cfg["kernels"]]
    return cfg


# ------------------------------------------------------------------ #
# Intra maps in band form
# ------------------------------------------------------------------ #
def balanced_band(counts, weights, width, dtype):
    """(n, width) balanced band of a count band; 0 where nothing is
    stored, NaN where a stored pixel has a bin without weight."""
    n = counts.shape[0]
    c = counts[:, :width].to(dtype)
    if c.shape[1] < width:
        c = torch.nn.functional.pad(c, (0, width - c.shape[1]))
    w = weights.to(dtype)
    w_j = torch.cat([w, w.new_zeros(width)]).unfold(0, width, 1)[:n]
    return torch.where(c > 0, c * w[:, None] * w_j, torch.zeros((), dtype=dtype, device=c.device))


def detrend(band, detect, keep_dist, n_diags):
    """Distance-law detrend, >= 10 reset to 1, trim past ``keep_dist``,
    NaN to 0."""
    n, width = band.shape
    dev = band.device
    det_j = torch.cat([detect, detect.new_zeros(width)]).unfold(0, width, 1)[:n]
    i = torch.arange(n, device=dev)[:, None]
    d = torch.arange(width, device=dev)[None, :]
    use = (i + d < n) & (band > 0) & detect[:, None] & det_j
    zero = torch.zeros((), dtype=band.dtype, device=dev)
    sums = torch.where(use, band, zero).sum(0)
    cnt = use.to(band.dtype).sum(0)
    law = torch.where(cnt > 0, sums / cnt, zero)
    law = torch.where(d[0] < n_diags, law, zero)
    out = torch.where(band != 0, band / law[None, :], zero)
    out = torch.where(out >= 10, torch.ones((), dtype=band.dtype, device=dev), out)
    out = torch.where(d <= keep_dist, out, zero)
    return torch.where(torch.isnan(out), zero, out)


def frame(band, missing, kernel_shape, n, max_dist):
    """The padded signal band and missing mask of full mode, in band
    coordinates: (mk - 1) rows above and below, ``kh + kw`` columns on
    each side.  The mask holds the missing rows and columns within the
    scan distance, the top frame, the ``max(mk, nk)`` diagonals below the
    main one and the right margin of the last rows."""
    width = band.shape[1]
    mk, nk = kernel_shape
    dev = band.device
    big_k = max(mk, nk)
    i = torch.arange(n, device=dev)[:, None]
    d = torch.arange(width, device=dev)[None, :]
    inside = i + d < n
    sig = torch.where(inside, band, torch.zeros((), dtype=band.dtype, device=dev))
    miss_j = torch.cat([missing, missing.new_zeros(width)]).unfold(0, width, 1)[:n]
    mask = (missing[:, None] | miss_j) & (d <= max_dist) & inside
    reach = (mk - 1) // 2 + (nk - 1) // 2
    pad = (reach, reach, mk - 1, mk - 1)
    sig_p = torch.nn.functional.pad(sig, pad)
    mask_p = torch.nn.functional.pad(mask.to(band.dtype), pad)
    pi = torch.arange(mask_p.shape[0], device=dev)[:, None] - (mk - 1)
    pd = torch.arange(mask_p.shape[1], device=dev)[None, :] - reach
    rules = (pi < 0) | ((pd >= mk - nk - big_k) & (pd <= mk - nk - 1)) | (
        (pi + pd >= n) & (pi >= n - max_dist - 2))
    return sig_p, mask_p.masked_fill_(rules, 1.0)


def window_sums(xp, planes, n_rows, width):
    """``out[p, i, d] = sum_{u,v} planes[p][u, v] xp[i + kh + u, d + mk - 1 - u + v]``:
    the window sums of the (mk, nk) ``planes`` in band coordinates, tap by
    tap in a fixed order, in ``xp``'s dtype."""
    planes = torch.as_tensor(np.asarray(planes), dtype=xp.dtype, device=xp.device)
    n_p, mk, nk = planes.shape
    kh = (mk - 1) // 2
    out = xp.new_zeros((n_p, n_rows, width))
    for u in range(mk):
        for v in range(nk):
            w = mk - 1 - u + v
            tap = planes[:, u, v][:, None, None]
            out += tap * xp[None, kh + u : kh + u + n_rows, w : w + width]
    return out


def snap(t):
    return torch.where(t.abs() < SNAP, torch.zeros((), dtype=t.dtype, device=t.device), t)


def log10_pvalue(corr, n_pres):
    """Two-sided log10 p-value of ``corr`` over ``n_pres`` pixels (Fisher z)."""
    z = torch.atanh(corr)
    tail = torch.special.log_ndtr(-(z * torch.sqrt(n_pres - 3)).abs())
    return (tail + math.log(2.0)) / math.log(10.0)


def pearson(s_k, s_x, s_x2, s_m, s_mk, s_mk2, kernel, missing_tol):
    """Missing-corrected Pearson from the window sums of one kernel:
    ``s_k`` sum of K x / ksize, ``s_x``/``s_x2`` sums of x and x^2,
    ``s_m``, ``s_mk``, ``s_mk2`` sums of m, K m, K^2 m.  (corr, n_pres)."""
    ksize = kernel.size
    ksum, k2sum = float(kernel.sum()), float((kernel * kernel).sum())
    conv_k, n_miss, conv_mk, conv_mk2 = snap(s_k), snap(s_m), snap(s_mk), snap(s_mk2)
    sig_mean0, sig2_mean0 = snap(s_x / ksize), snap(s_x2 / ksize)
    n_pres = ksize - n_miss
    kmean = (ksum - conv_mk) / n_pres
    k2mean = (k2sum - conv_mk2) / n_pres
    corr_f = ksize / n_pres
    sig_mean = sig_mean0 * corr_f
    sig2_mean = sig2_mean0 * corr_f
    denom = torch.sqrt((sig2_mean - sig_mean * sig_mean) * (k2mean - kmean * kmean))
    denom = torch.where(n_pres < int((1 - missing_tol) * ksize), 0.0, denom)
    num = (conv_k - sig_mean * kmean / corr_f) * corr_f
    out = torch.where(denom.abs() < 1e-10, 0.0, num / denom)
    return torch.where(torch.isfinite(out), out, 0.0).clamp(-1.0, 1.0), n_pres


def band_pearson(band, missing, kernels, n, max_dist, missing_tol, work=None):
    """(corr, log10 p) of each kernel over the band, (K, n, W) each; corr
    0 outside the scan distance and the map.  Computed in row blocks.
    ``work`` (a list) gets the (FMAs, bytes) the inputs need: mk nk K FMAs
    per non-zero framed signal pixel (its product with each kernel) and
    mk nk 2K per set framed mask bit (with each kernel and its square);
    the box sums of the signal, its square and the mask take no
    multiplication and are not counted, as a prefix sum needs O(1) adds a
    pixel for them; the float32 band and the missing flags read and the
    float32 corr and log10 p and a candidate byte per pixel and kernel
    written."""
    mk, nk = kernels[0].shape
    width = band.shape[1]
    sig_p, mask_p = frame(band, missing, (mk, nk), n, max_dist)
    if work is not None:
        n_k, taps = len(kernels), mk * nk
        fma = taps * n_k * (int(torch.count_nonzero(sig_p))
                            + 2 * int(torch.count_nonzero(mask_p)))
        work.append((fma, n * width * 4 + n + n_k * n * width * 9))
    ksize = mk * nk
    ones = np.ones((mk, nk))
    sig_planes = [k / ksize for k in kernels] + [ones]
    mask_planes = [ones] + list(kernels) + [k * k for k in kernels]
    n_k = len(kernels)
    corr = band.new_zeros((n_k, n, width))
    logp = band.new_zeros((n_k, n, width))
    d = torch.arange(width, device=band.device)[None, :]
    block = max(64, BLOCK_ELEMENTS // width)
    for r0 in range(0, n, block):
        rows = min(block, n - r0)
        xs = sig_p[r0 : r0 + rows + 2 * (mk - 1)]
        ms = mask_p[r0 : r0 + rows + 2 * (mk - 1)]
        s_sig = window_sums(xs, sig_planes, rows, width)
        s_x2 = window_sums(xs * xs, [ones], rows, width)[0]
        s_mask = window_sums(ms, mask_planes, rows, width)
        i = torch.arange(r0, r0 + rows, device=band.device)[:, None]
        keep = (d <= max_dist) & (i + d < n)
        for k, kernel in enumerate(kernels):
            c, n_pres = pearson(s_sig[k], s_sig[n_k], s_x2, s_mask[0], s_mask[1 + k],
                                s_mask[1 + n_k + k], kernel, missing_tol)
            logp[k, r0 : r0 + rows] = log10_pvalue(c, n_pres)
            corr[k, r0 : r0 + rows] = torch.where(keep, c, 0.0)
    return corr, logp


def best_of_foci(rows, cols, scores, min_size=2):
    """The best pixel of each 4-connected focus of at least ``min_size``
    of the given pixels (max score, ties to the first row-major pixel):
    an (F, 2) int64 array, in the order of the foci's first pixels."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n_px = len(rows)
    if n_px == 0:
        return np.zeros((0, 2), dtype=np.int64)
    order = np.lexsort((cols, rows))
    rows, cols, scores = rows[order], cols[order], scores[order]
    key = rows.astype(np.int64) * (int(cols.max()) + 2) + cols
    edges_a, edges_b = [], []
    for dr, dc in ((0, 1), (1, 0)):
        nb = (rows + dr).astype(np.int64) * (int(cols.max()) + 2) + cols + dc
        pos = np.searchsorted(key, nb)
        ok = pos < n_px
        ok[ok] = key[pos[ok]] == nb[ok]
        edges_a.append(np.flatnonzero(ok))
        edges_b.append(pos[ok])
    a, b = np.concatenate(edges_a), np.concatenate(edges_b)
    graph = sp.coo_matrix((np.ones(len(a)), (a, b)), shape=(n_px, n_px))
    _, labels = connected_components(graph, directed=False)
    # foci in the order of their first row-major pixel
    first = np.full(labels.max() + 1, n_px)
    np.minimum.at(first, labels, np.arange(n_px))
    rank = np.argsort(np.argsort(first))
    focus = rank[labels]
    size = np.bincount(focus)
    best = np.lexsort((np.arange(n_px), -scores, focus))
    starts = np.searchsorted(focus[best], np.arange(len(size)))
    pick = best[starts][size >= min_size]
    return np.stack([rows[pick], cols[pick]], axis=1).astype(np.int64)


def windows_at(values, get_missing, coords, kernel_shape, shape, below_diag):
    """(windows, valid) of full-mode validation at matrix ``coords``:
    ``values(r, c)`` reads the preprocessed map (0 outside), windows NaN
    on missing rows and columns, outside the map and, on an intra map,
    on the ``below_diag`` diagonals under the main one."""
    mk, nk = kernel_shape
    kh, kw = (mk - 1) // 2, (nk - 1) // 2
    half_h, half_w = mk // 2 + 1, nk // 2 + 1
    p1, p2 = coords[:, 0], coords[:, 1]
    n1, n2 = shape
    inbound = ((p1 + kh - half_h + 1 >= 0) & (p1 + kh + half_h < n1 + 2 * kh)
               & (p2 + kw - half_w + 1 >= 0) & (p2 + kw + half_w < n2 + 2 * kw))
    r = p1[:, None] - half_h + 1 + np.arange(mk)[None, :]
    c = p2[:, None] - half_w + 1 + np.arange(nk)[None, :]
    rr, cc = np.broadcast_arrays(r[:, :, None], c[:, None, :])
    wins = values(rr, cc)
    if below_diag:
        dd = rr - cc
        wins = np.where((dd >= 1) & (dd <= below_diag), np.nan, wins)
    miss_r, miss_c = get_missing
    row_missing = (r < 0) | (r >= n1) | miss_r[np.clip(r, 0, n1 - 1)]
    col_missing = (c < 0) | (c >= n2) | miss_c[np.clip(c, 0, n2 - 1)]
    wins = np.where(row_missing[:, :, None], np.nan, wins)
    wins = np.where(col_missing[:, None, :], np.nan, wins)
    return wins, inbound


def validity(wins, inbound, zero_tol, missing_tol):
    tot = wins.shape[1] * wins.shape[2]
    n_missing = np.sum(~np.isfinite(wins), axis=(1, 2))
    n_zero = np.sum(wins == 0, axis=(1, 2))
    with np.errstate(invalid="ignore", divide="ignore"):
        return inbound & (n_missing / tot < missing_tol) & (n_zero / (tot - n_missing) < zero_tol)


def detect_intra(genome, c, cfg, dtype, device, work=None, map_dtype=None):
    """Calls of every kernel on chromosome ``c``: a list, per kernel, of
    (bin1, bin2, score, log10 p, windows) in local bins, or None."""
    n = genome.sizes[c]
    binsize = genome.binsize
    kernels = cfg["kernels"]
    mk, nk = kernels[0].shape
    largest = max(k.shape[0] for k in kernels)
    max_dist = max(cfg["max_dist"] // binsize, 1)
    keep_dist = min(max_dist, n) + largest
    width = keep_dist + 1
    off = int(genome.offsets[c])
    w = torch.from_numpy(genome.weights[off : off + n]).to(device)
    detect = torch.isfinite(w)
    missing = ~detect
    raw = balanced_band(genome.bands[c].to(device), w, width, dtype)
    band = detrend(raw, detect, keep_dist, min(keep_dist + 1, n))
    del raw
    if map_dtype is not None:
        band = band.to(map_dtype).to(dtype)
    missing_tol = cfg["max_perc_undetected"] / 100
    corr, logp = band_pearson(band, missing, kernels, n, max_dist, missing_tol, work)
    band_h = band.cpu().numpy().astype(np.float64)
    miss_h = missing.cpu().numpy()

    def values(rr, cc):
        dd = cc - rr
        ok = (rr >= 0) & (rr < n) & (dd >= 0) & (dd < width)
        return np.where(ok, band_h[np.clip(rr, 0, n - 1), np.clip(dd, 0, width - 1)], 0.0)

    out = []
    for k, kernel in enumerate(kernels):
        cand = (corr[k] >= cfg["pearson"]) & (corr[k] != 0)
        ii, dd = torch.nonzero(cand, as_tuple=True)
        sc = corr[k][ii, dd].cpu().numpy().astype(np.float64)
        ii, dd = ii.cpu().numpy(), dd.cpu().numpy()
        coords = best_of_foci(ii, ii + dd, sc)
        if len(coords) == 0:
            out.append(None)
            continue
        if cfg["max_dist"] == 0:
            coords[:, 0] = coords[:, 1]
        dsc = coords[:, 1] - coords[:, 0]
        in_band = (coords[:, 0] >= 0) & (coords[:, 0] < n) & (dsc >= 0) & (dsc < width)
        ri = torch.from_numpy(np.clip(coords[:, 0], 0, n - 1)).to(corr.device)
        di = torch.from_numpy(np.clip(dsc, 0, width - 1)).to(corr.device)
        score = np.where(in_band, corr[k][ri, di].cpu().numpy().astype(np.float64), 0.0)
        lp = np.where(in_band, logp[k][ri, di].cpu().numpy().astype(np.float64), np.nan)
        wins, inbound = windows_at(values, (miss_h, miss_h), coords, (mk, nk), (n, n),
                                   max(mk, nk))
        valid = validity(wins, inbound, cfg["max_perc_zero"] / 100, missing_tol)
        out.append((coords[valid, 0], coords[valid, 1], score[valid], lp[valid], wins[valid]))
    return out


# ------------------------------------------------------------------ #
# Inter maps
# ------------------------------------------------------------------ #
def _median(t):
    """numpy's median (mean of the two middle values) of a 1-D tensor."""
    s = torch.sort(t).values
    k = s.numel()
    return (s[(k - 1) // 2] + s[k // 2]) / 2


def _present(flags, half, n_out):
    """(n_out, 2 half + 1) window of ``flags`` (1 = present) around each
    output index, 0 outside."""
    padded = torch.cat([flags.new_zeros(half), flags, flags.new_zeros(half)])
    return padded.unfold(0, 2 * half + 1, 1)[:n_out]


# (contact, tap) pairs of the trans scatter held at once
PAIRS = 1 << 24


def detect_inter(genome, c1, c2, cfg, dtype, device, map_dtype=None):
    """Calls of every kernel on the trans map of chromosomes (c1, c2), as
    ``detect_intra``, in full mode: the map divided by the median of its
    stored pixels (NaN ones as 0), the pixels outside the map and on
    missing rows or columns missing.  A window holding no contact has
    corr 0, so the Pearson is evaluated only where a window holds one: the
    signal sums are scattered from each contact to the windows that hold
    it, and the mask sums of the crossing missing mask are separable."""
    n1, n2 = genome.sizes[c1], genome.sizes[c2]
    rows, cols, counts = (t.to(device) for t in genome.trans[(c1, c2)])
    o1, o2 = int(genome.offsets[c1]), int(genome.offsets[c2])
    w1 = torch.from_numpy(genome.weights[o1 : o1 + n1]).to(device).to(dtype)
    w2 = torch.from_numpy(genome.weights[o2 : o2 + n2]).to(device).to(dtype)
    vals = counts.to(dtype) * w1[rows] * w2[cols]
    vals = torch.where(torch.isnan(vals), 0.0, vals)
    if vals.numel():
        vals = vals / _median(vals)
    if map_dtype is not None:
        vals = vals.to(map_dtype).to(dtype)
    stored = vals != 0
    rows, cols, vals = rows[stored], cols[stored], vals[stored]
    kernels = cfg["kernels"]
    n_k = len(kernels)
    mk, nk = kernels[0].shape
    kh, kw = (mk - 1) // 2, (nk - 1) // 2
    ksize = mk * nk
    missing_tol = cfg["max_perc_undetected"] / 100
    ktab = torch.as_tensor(np.stack(kernels), dtype=dtype, device=device)
    miss_r, miss_c = torch.isnan(w1), torch.isnan(w2)
    pr = _present((~miss_r).to(dtype), kh, n1)  # (n1, mk)
    pc = _present((~miss_c).to(dtype), kw, n2)  # (n2, nk)
    g1 = torch.einsum("kuv,jv->kju", ktab, pc)  # sum_v K[u, v] present_c[j - kw + v]
    g2 = torch.einsum("kuv,jv->kju", ktab * ktab, pc)
    du = torch.arange(mk, device=device)
    dv = torch.arange(nk, device=device)
    tap_k = (ktab / ksize).reshape(n_k, -1)
    found_i, found_j, found_c, found_p = [[] for _ in range(n_k)], [[] for _ in range(n_k)], \
        [[] for _ in range(n_k)], [[] for _ in range(n_k)]
    block_rows = max(1, int(PAIRS / (ksize * max(1.0, len(rows) / n1))))
    for r0 in range(0, n1, block_rows):
        r1 = min(n1, r0 + block_rows)
        sel = (rows >= r0 - kh) & (rows < r1 + kh)
        r, c, x = rows[sel], cols[sel], vals[sel]
        oi = r[:, None, None] + kh - du[None, :, None]
        oj = c[:, None, None] + kw - dv[None, None, :]
        oi, oj = oi.expand(-1, mk, nk), oj.expand(-1, mk, nk)
        ok = (oi >= r0) & (oi < r1) & (oj >= 0) & (oj < n2)
        taps = torch.arange(ksize, device=device).reshape(1, mk, nk).expand_as(oi)[ok]
        xs = x[:, None, None].expand(-1, mk, nk)[ok]
        key, inv = torch.unique(oi[ok] * n2 + oj[ok], return_inverse=True)
        if key.numel() == 0:
            continue
        m = key.numel()
        s_x = torch.zeros(m, dtype=dtype, device=device).index_add_(0, inv, xs)
        s_x2 = torch.zeros(m, dtype=dtype, device=device).index_add_(0, inv, xs * xs)
        s_k = torch.zeros((n_k, m), dtype=dtype, device=device)
        for k in range(n_k):
            s_k[k].index_add_(0, inv, tap_k[k][taps] * xs)
        oi_u, oj_u = key // n2, key % n2
        pri, pcj = pr[oi_u], pc[oj_u]  # (m, mk), (m, nk)
        s_m = ksize - pri.sum(1) * pcj.sum(1)
        for k in range(n_k):
            s_mk = float(kernels[k].sum()) - (pri * g1[k][oj_u]).sum(1)
            s_mk2 = float((kernels[k] ** 2).sum()) - (pri * g2[k][oj_u]).sum(1)
            corr, n_pres = pearson(s_k[k], s_x, s_x2, s_m, s_mk, s_mk2, kernels[k], missing_tol)
            cand = (corr >= cfg["pearson"]) & (corr != 0)
            found_i[k].append(oi_u[cand].cpu())
            found_j[k].append(oj_u[cand].cpu())
            found_c[k].append(corr[cand].cpu())
            found_p[k].append(log10_pvalue(corr[cand], n_pres[cand]).cpu())
    mr, mc = miss_r.cpu().numpy(), miss_c.cpu().numpy()
    skey = (rows * n2 + cols).cpu().numpy()
    svals = vals.cpu().to(torch.float64).numpy()
    order = np.argsort(skey)
    skey, svals = skey[order], svals[order]

    def values(rr, cc):
        ok = (rr >= 0) & (rr < n1) & (cc >= 0) & (cc < n2)
        flat = np.clip(rr, 0, n1 - 1) * n2 + np.clip(cc, 0, n2 - 1)
        pos = np.clip(np.searchsorted(skey, flat), 0, max(len(skey) - 1, 0))
        hit = ok & (skey[pos] == flat) if len(skey) else np.zeros_like(ok)
        return np.where(hit, svals[pos] if len(skey) else 0.0, 0.0)

    out = []
    for k in range(n_k):
        if not found_i[k]:
            out.append(None)
            continue
        ci = torch.cat(found_i[k]).numpy()
        cj = torch.cat(found_j[k]).numpy()
        cc = torch.cat(found_c[k]).to(torch.float64).numpy()
        cp = torch.cat(found_p[k]).to(torch.float64).numpy()
        coords = best_of_foci(ci, cj, cc)
        if len(coords) == 0:
            out.append(None)
            continue
        at = {f: i for i, f in enumerate((ci * n2 + cj).tolist())}
        idx = np.array([at[f] for f in (coords[:, 0] * n2 + coords[:, 1]).tolist()])
        wins, inbound = windows_at(values, (mr, mc), coords, (mk, nk), (n1, n2), 0)
        valid = validity(wins, inbound, cfg["max_perc_zero"] / 100, missing_tol)
        out.append((coords[valid, 0], coords[valid, 1], cc[idx][valid], cp[idx][valid],
                    wins[valid]))
    return out


# ------------------------------------------------------------------ #
# The whole command
# ------------------------------------------------------------------ #
def remove_neighbours(b1, b2, score, win):
    """Whitelist after greedy suppression of rows closer than ``win`` on
    both axes, best score first, NaN last, ties to the earlier row."""
    n = len(b1)
    keep = np.ones(n, dtype=bool)
    order = np.lexsort((np.arange(n), -np.nan_to_num(score, nan=-np.inf)))
    order = np.concatenate([order[~np.isnan(score[order])], order[np.isnan(score[order])]])
    killed = np.zeros(n, dtype=bool)
    cells = {}
    for i in range(n):
        cells.setdefault((b1[i] // win, b2[i] // win), []).append(i)
    for i in order:
        if killed[i]:
            continue
        c1, c2 = b1[i] // win, b2[i] // win
        for d1 in (-1, 0, 1):
            for d2 in (-1, 0, 1):
                for j in cells.get((c1 + d1, c2 + d2), ()):
                    if j != i and abs(b1[j] - b1[i]) < win and abs(b2[j] - b2[i]) < win:
                        killed[j] = True
    keep[killed] = False
    return keep


def fdr(pvals):
    """Benjamini-Hochberg q-values."""
    pvals = np.asarray(pvals, dtype=np.float64)
    n = len(pvals)
    if n == 0:
        return pvals
    desc = np.argsort(-pvals, kind="stable")
    steps = n / np.arange(n, 0, -1)
    q = np.minimum(1, np.minimum.accumulate(steps * pvals[desc]))
    out = np.empty(n)
    out[desc] = q
    return out


def detect(genome, pattern, inter=False, dtype=torch.float64, device="cpu", work=None,
           map_dtype=None):
    """The reference's ``detect`` of ``genome`` with the pattern
    ``pattern`` (a ``patterns/`` name): a table (dict of numpy columns:
    chrom1, start1, chrom2, start2, bin1, bin2, kernel_id, score, pvalue,
    qvalue) and its windows, in the program's row order (kernel-major,
    then map order).  ``work`` (a dict) gets ``band_launches``, the
    (FMAs, bytes) each band map's inputs need (``band_pearson``).
    ``map_dtype`` rounds the preprocessed maps (the windows' values) to
    that type: the lower-precision control's bfloat16 maps."""
    cfg = load_pattern(pattern)
    n_k = len(cfg["kernels"])
    maps = [(c, c) for c in range(len(genome.sizes))]
    if inter:
        maps = [(c1, c2) for c1 in range(len(genome.sizes))
                for c2 in range(len(genome.sizes)) if c1 <= c2]
    per_kernel = [[] for _ in range(n_k)]
    for c1, c2 in maps:
        if c1 == c2:
            launches = None if work is None else work.setdefault("band_launches", [])
            found = detect_intra(genome, c1, cfg, dtype, device, launches, map_dtype)
        else:
            found = detect_inter(genome, c1, c2, cfg, dtype, device, map_dtype)
        for k in range(n_k):
            if found[k] is not None:
                b1, b2, sc, lp, wins = found[k]
                per_kernel[k].append((b1 + genome.offsets[c1], b2 + genome.offsets[c2],
                                      sc, lp, wins))
    parts = [(k, p) for k in range(n_k) for p in per_kernel[k]]
    mk, nk = cfg["kernels"][0].shape
    if not parts:
        return None, np.zeros((0, mk, nk))
    b1 = np.concatenate([p[0] for _, p in parts]).astype(np.int64)
    b2 = np.concatenate([p[1] for _, p in parts]).astype(np.int64)
    score = np.concatenate([p[2] for _, p in parts])
    pvalue = 10 ** np.concatenate([p[3] for _, p in parts])
    kid = np.concatenate([np.full(len(p[0]), k) for k, p in parts])
    wins = np.concatenate([p[4] for _, p in parts])
    keep = remove_neighbours(b1, b2, score, max(1, int(cfg["min_separation"] // genome.binsize)))
    chrom_of = np.searchsorted(genome.offsets, np.arange(genome.n_bins), side="right") - 1
    b1, b2, score, pvalue, kid, wins = (a[keep] for a in (b1, b2, score, pvalue, kid, wins))
    c1, c2 = chrom_of[b1], chrom_of[b2]
    start1 = (b1 - genome.offsets[c1]) * genome.binsize
    start2 = (b2 - genome.offsets[c2]) * genome.binsize
    too_close = (c1 == c2) & (np.abs(start2 - start1) < cfg["min_dist"])
    keep = ~too_close & ~np.isnan(pvalue)
    table = {
        "chrom1": np.array(genome.names)[c1[keep]], "start1": start1[keep],
        "chrom2": np.array(genome.names)[c2[keep]], "start2": start2[keep],
        "bin1": b1[keep], "bin2": b2[keep], "kernel_id": kid[keep],
        "score": score[keep], "pvalue": pvalue[keep],
    }
    table["qvalue"] = fdr(table["pvalue"])
    return table, wins[keep]
