"""Missing-corrected sliding-window Pearson on dense tensors.

Counterpart of ``chromosight_tpu/ops/normxcorr.py``: the dense engine
(``normxcorr2_dense``, one map on the device) and the crossing Pearson
(``normxcorr_crossing_valid``) that the tiled engine runs on batches of
tiles of an inter-chromosomal map, whose missing mask is a crossing of
missing rows and missing columns.

The window sums are formed in float64 (``ops.convolve``) with the float64
taps of the float64 kernel, snapped to 0 below 1e-4 on their float32
rounding, and enter the float64 Pearson algebra of the band engine
(``ops.band.pearson_algebra``) unrounded; corr and log10 p are rounded to
float32 once, at the end.  The parity
rules of the reference are kept: windows with fewer than
``int((1 - missing_tol) * ksize)`` present pixels are 0, denominators
below 1e-10 give 0, non-finite values become 0, coefficients are clamped
to [-1, 1], ``sym_upper`` keeps the upper triangle in framed coordinates,
and the log10 p-value takes per-window observation counts only in full
(or ``force_window_nobs``) mode.  The p-value is the erfcx form of
``log_ndtr`` that the band kernel uses (``ops.band_pearson``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chromosight_torch.ops.band import (
    pearson_algebra,
    pearson_from_sums,
    rounded_pearson,
    snap64,
)
from chromosight_torch.ops.band_pearson import log10_pvalue
from chromosight_torch.ops.convolve import (
    DEFAULT_THRESHOLD,
    conv2d_valid,
    conv2d_valid_separable,
    pad_margins,
    window_sum_valid,
)
from chromosight_torch.preprocessing import factorise_kernel


def make_missing_mask_dense(
    shape, missing_rows, missing_cols, max_dist=None, sym_upper=False
):
    """Dense boolean missing-pixel mask (True = missing) from per-bin
    missing flags (bool tensors of length shape[0] and shape[1]): full
    crosses, or for upper-symmetric maps each missing bin's row segment to
    the right and column segment upwards over ``max_dist`` diagonals
    (``chromosight_tpu/ops/normxcorr.py:52-77``)."""
    cross = missing_rows[:, None] | missing_cols[None, :]
    if not sym_upper:
        return cross
    md = min(shape) if max_dist is None else max_dist
    dev = missing_rows.device
    d = torch.arange(shape[1], device=dev)[None, :] - torch.arange(shape[0], device=dev)[:, None]
    return cross & (d >= 0) & (d <= md)


def frame_missing_mask_dense(mask, kernel_shape, sym_upper=False, max_dist=None):
    """Frame a dense missing mask with kernel-sized margins, with the
    reference's rules: every margin pixel missing, or for banded
    upper-symmetric maps the top frame, its corner and the right margin of
    the last rows only; and for symmetric maps the ``max(kernel_shape)``
    diagonals below the main one (``chromosight_tpu/ops/normxcorr.py:80-120``)."""
    ms, ns = mask.shape
    mk, nk = kernel_shape
    big_k = max(mk, nk)
    banded = sym_upper and max_dist is not None
    dev = mask.device
    inner = mask
    if banded:
        i = torch.arange(ms, device=dev)[:, None]
        j = torch.arange(ns, device=dev)[None, :]
        inner = inner & (j - i >= 0) & (j - i <= max_dist + big_k)
    framed = F.pad(inner, (nk - 1, nk - 1, mk - 1, mk - 1))
    r = torch.arange(framed.shape[0], device=dev)[:, None]
    c = torch.arange(framed.shape[1], device=dev)[None, :]
    in_rows = (r >= mk - 1) & (r < mk - 1 + ms)
    in_cols = (c >= nk - 1) & (c < nk - 1 + ns)
    if banded:
        top = (r < mk - 1) & in_cols & (c - (nk - 1) < max_dist + nk)
        corner = (r < mk - 1) & (c < nk - 1)
        right = (c >= nk - 1 + ns) & (r >= (ms + 2 * (mk - 1)) - (max_dist + mk + 1))
        frame = top | corner | right
    else:
        frame = ~(in_rows & in_cols)
    framed = framed | frame
    if sym_upper:
        framed = framed | ((c - r >= -big_k) & (c - r <= -1))
    return framed


def build_tsvd_pack(kernel, tsvd):
    """The ``--tsvd`` factors of the three convolved kernels, K/ksize for
    the numerator and K, K^2 for the mask sums, each factorised on its own
    in float64 and cast to float32, as the reference does
    (``chromosight_tpu/ops/normxcorr.py:432-450``): three (left, right)
    pairs of float32 numpy arrays."""
    knp = np.asarray(kernel, dtype=np.float64)

    def fact(mat):
        left, right = factorise_kernel(mat, prop_info=tsvd)
        return left.astype(np.float32), right.astype(np.float32)

    return fact(knp / knp.size), fact(knp), fact(knp**2)


def _taps(kernel):
    """The float64 kernel K, its taps K/ksize and K^2, and the sums ksum
    and k2sum, all float64 (``ops.band.kernel_coefficients``)."""
    k64 = torch.from_numpy(np.array(kernel, dtype=np.float64))
    k2 = k64 * k64
    return k64, k64 / k64.numel(), k2, k64.sum(), k2.sum()


def _conv(x, taps, factors):
    """Float64 correlation with a tap plane, or with its ``--tsvd``
    factors when given."""
    if factors is not None:
        return conv2d_valid_separable(x, *factors)
    return conv2d_valid(x, taps)


def numerator_taps(kernel):
    """The float64 taps K/ksize of the Pearson numerator's correlation."""
    return _taps(kernel)[1]


def pearson_valid(framed, mask, kernel, tsvd_pack=None, missing_tol=0.75,
                  threshold=DEFAULT_THRESHOLD, sums=None):
    """Valid-mode missing-corrected Pearson of a framed float32 signal
    ((H, W) or a (B, H, W) stack) and its missing mask (bool, same shape,
    or None for no mask), before any triangle rule and before rounding:
    float64 ``(corr, n_pres)`` of shape (..., H-mk+1, W-nk+1), ``n_pres``
    None without a mask (``chromosight_tpu/ops/normxcorr.py:184-237``).  ``sums``, when the
    caller has them, are the float64 planes (correlation with
    ``numerator_taps``, window sums of x and x^2) that the tiled engine
    forms from a sparse batch's entries (``window_sums_entries``)."""
    mk, nk = np.shape(kernel)
    ksize = mk * nk
    k64, k_scaled, k2, ksum, k2sum = _taps(kernel)
    tsvd_num, tsvd_k, tsvd_k2 = tsvd_pack if tsvd_pack is not None else (None,) * 3
    x = framed.float()
    if sums is None:
        sums = _window_sums(x, k_scaled, tsvd_num)
    s_k, s_x, s_x2 = sums
    if mask is None:
        inv_ksize = float(1.0 / torch.tensor(float(ksize), dtype=torch.float32))
        sig_mean = snap64(s_x.double() / ksize, threshold, s_x.float() * inv_ksize)
        sig2_mean = snap64(s_x2.double() / ksize, threshold, s_x2.float() * inv_ksize)
        del s_x, s_x2
        denom = torch.sqrt(sig2_mean - sig_mean**2) * k64.std(correction=0).item()
        inv_denom = torch.where(denom.abs() < 1e-10, 0.0, 1.0 / denom)
        num = snap64(s_k, threshold) - sig_mean * k64.mean().item()
        out = num * inv_denom
        return torch.where(torch.isfinite(out), out, 0.0).clamp(-1.0, 1.0), None
    m = mask.to(torch.float32)
    sums = torch.stack([ksum, k2sum])[None]
    out, n_pres = pearson_from_sums(
        s_k[None],
        s_x,
        s_x2,
        window_sum_valid(m, (mk, nk)),
        _conv(m, k64, tsvd_k)[None],
        _conv(m, k2, tsvd_k2)[None],
        sums,
        ksize,
        missing_tol,
        threshold,
    )
    return out[0], n_pres


def _window_sums(x, k_scaled, factors=None):
    """The float64 numerator correlation and window sums of x and x^2 of
    a float32 (..., H, W) signal."""
    window = np.shape(k_scaled)
    return (
        _conv(x, k_scaled, factors),
        window_sum_valid(x, window),
        window_sum_valid(x.double() ** 2, window),
    )


def normxcorr_impl(signal, kernel, mask=None, tsvd_pack=None, full=False,
                   sym_upper=False, missing_tol=0.75, pval=False,
                   threshold=DEFAULT_THRESHOLD, force_window_nobs=False):
    """The fused Pearson of ``chromosight_tpu/ops/normxcorr.py:152-268``
    on a (H, W) float32 signal (framed here when ``full``) and its framed
    missing mask or None: ``(corr, log10p or None)`` shaped like the
    signal, zero margins where the kernel overlaps an edge."""
    mk, nk = np.shape(kernel)
    ksize = mk * nk
    framed = signal.float()
    if full:
        framed = F.pad(framed, (nk - 1, nk - 1, mk - 1, mk - 1))
    out, n_pres = pearson_valid(framed, mask, kernel, tsvd_pack, missing_tol, threshold)
    out = pad_margins(out, (mk, nk))
    if n_pres is not None and (full or force_window_nobs):
        n_obs = pad_margins(n_pres, (mk, nk), value=float(ksize))
    else:
        n_obs = torch.full_like(out, float(ksize))
    if sym_upper:
        r = torch.arange(out.shape[0], device=out.device)[:, None]
        c = torch.arange(out.shape[1], device=out.device)[None, :]
        out = torch.where(c >= r, out, 0.0)
    out, logp = rounded_pearson(out, n_obs, log10_pvalue)
    logp = logp if pval else None
    if full:
        out = out[mk - 1 : out.shape[0] - (mk - 1), nk - 1 : out.shape[1] - (nk - 1)]
        if logp is not None:
            logp = logp[mk - 1 : logp.shape[0] - (mk - 1), nk - 1 : logp.shape[1] - (nk - 1)]
    return out, logp


def crossing_pearson(block, rvec, cvec, kernel, missing_tol=0.75,
                     threshold=DEFAULT_THRESHOLD, sums=None):
    """``normxcorr_crossing_valid`` before its p-value and before
    rounding: float64 ``(corr, n_pres)`` in valid shape.  ``block`` (..., H, W) float32, ``rvec``
    (..., H) and ``cvec`` (..., W) bool missing flags; ``sums`` as for
    ``pearson_valid``.

    With m = 1 - (1 - r)(1 - c) the three mask sums collapse: per output
    pixel, conv(m, K) = ksum - sum_u (1 - r[i+u]) (K @ (1 - c))[u, j],
    the same with K^2, and the missing count is ksize - (sum_u (1 - r))
    (sum_v (1 - c)): two rank-mk products (float64 matmuls) instead of
    three dense correlations over mask blocks."""
    mk, nk = np.shape(kernel)
    ksize = mk * nk
    h_out = block.shape[-2] - mk + 1
    w_out = block.shape[-1] - nk + 1
    k64, k_scaled, k2, ksum, k2sum = _taps(kernel)
    ksize_f = torch.tensor(float(ksize), dtype=torch.float32)
    s_k, s_x, s_x2 = _window_sums(block.float(), k_scaled) if sums is None else sums
    conv_sk = snap64(s_k, threshold)
    sig_mean0 = snap64(s_x.double() / ksize, threshold, s_x.float() / ksize_f)
    sig2_mean0 = snap64(s_x2.double() / ksize, threshold, s_x2.float() / ksize_f)
    del s_k, s_x, s_x2
    dev = block.device
    nr = (~rvec).to(torch.float64).unfold(-1, h_out, 1)  # (..., mk, h_out)
    nc = (~cvec).to(torch.float64).unfold(-1, w_out, 1)  # (..., nk, w_out)
    planes = []
    for taps, total in ((k64, ksum), (k2, k2sum)):
        g = taps.to(dev) @ nc  # (..., mk, w_out)
        planes.append(snap64(float(total) - nr.transpose(-1, -2) @ g, threshold))
    n_miss = ksize - nr.sum(-2)[..., :, None] * nc.sum(-2)[..., None, :]
    n_miss = snap64(n_miss, threshold)
    dev_sums = [t.to(dev) for t in (ksum, k2sum)]
    return pearson_algebra(
        conv_sk, sig_mean0, sig2_mean0, n_miss, planes[0], planes[1], *dev_sums,
        ksize, missing_tol,
    )


def normxcorr_crossing_valid(block, rvec, cvec, kernel, missing_tol=0.75,
                             pval=False, threshold=DEFAULT_THRESHOLD):
    """Missing-corrected Pearson where the missing mask is exactly the
    crossing ``rvec | cvec`` (the inter-map case), in framed coordinates
    (margins marked missing, zero signal outside the matrix):
    ``(corr, log10p or None)`` in valid shape (H - mk + 1, W - nk + 1),
    with per-window observation counts
    (``chromosight_tpu/ops/normxcorr.py:280-429``)."""
    out, n_pres = crossing_pearson(block, rvec, cvec, kernel, missing_tol, threshold)
    out, logp = rounded_pearson(out, n_pres, log10_pvalue)
    return out, (logp if pval else None)


def normxcorr2_dense(
    signal,
    kernel,
    max_dist=None,
    sym_upper=False,
    full=False,
    missing_mask=None,
    missing_tol=0.75,
    tsvd=None,
    pval=False,
    threshold=DEFAULT_THRESHOLD,
):
    """Missing-aware sliding-window Pearson of a dense (H, W) tensor with
    an (mk, nk) kernel (``chromosight_tpu/ops/normxcorr.py:453-520``):
    ``missing_mask`` a bool tensor in unframed coordinates, framed here
    with ``frame_missing_mask_dense`` when ``full``; ``tsvd`` the energy
    share of the ``--tsvd`` factors.  Returns ``(corr, log10p or None)``,
    float32 tensors shaped like ``signal``."""
    kernel = np.asarray(kernel)
    if kernel.ndim != 2:
        raise ValueError("kernel must be 2D")
    if float(np.std(kernel.astype(np.float32))) == 0.0:
        raise ValueError("Cannot have flat kernel.")
    mk, nk = kernel.shape
    mask = None
    if missing_mask is not None:
        if missing_mask.dtype != torch.bool:
            raise ValueError(f"Missing mask dtype is {missing_mask.dtype}. Should be bool.")
        if tuple(missing_mask.shape) != tuple(signal.shape):
            raise ValueError("Signal and missing mask do not have the same shape")
        if min(kernel.shape) >= max(signal.shape):
            raise ValueError("cannot have kernel bigger than signal")
        mask = missing_mask
        if full:
            mask = frame_missing_mask_dense(mask, (mk, nk), sym_upper, max_dist)
    tsvd_pack = build_tsvd_pack(kernel, tsvd) if tsvd is not None else None
    return normxcorr_impl(
        signal, kernel, mask, tsvd_pack, full, sym_upper, missing_tol, pval, threshold,
    )
