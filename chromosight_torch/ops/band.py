"""Diagonal-band engine ops in plain PyTorch.

Counterpart of ``chromosight_tpu/ops/band.py``.  A chromosome's contact map
is kept as its upper band ``B[i, d] = M[i, i + d]``, ``d`` in [0, W), and
the missing-corrected Pearson of a (mk, nk) kernel runs in band
coordinates with the sheared kernel ``Ksh[u, mk-1-u+v] = K[u, v]``.

Every function here takes tensors on any device.  The Pearson hot spot is
``ops.band_pearson.band_pearson`` (a CUDA kernel on the card);
``pearson_reference_multi`` below is its plain twin for K same-shape
kernels (``pearson_reference`` for one), and ``band_normxcorr_reference``
the plain twin of the whole ``chromosight_tpu.ops.band.band_normxcorr``.
With ``tsvd`` the taps are the rank-truncated kernels of ``--tsvd``.
Quantify scores a few pixels through ``band_normxcorr_at_packed``, a
patch gather and a float64 matmul with no sweep.

Inputs and outputs are float32, as in the JAX package, but the taps and
the kernel's sums are float64 (``kernel_coefficients``), the six window
sums (up to mk*nk terms each) are accumulated in float64, and the Pearson
algebra and its log10 p-value run in float64 too (``pearson_from_sums``): each sum is snapped to 0 below 1e-4 on its
float32 rounding, as the JAX package decides it, and enters the algebra
unrounded; corr and log10 p are rounded to float32 once, at the end.  On
detrended contact maps the covariance in the numerator cancels most of
the sums, so float32 sums reach ~5e-5 of error in corr, and a float32
numerator of float64 sums still cancels to 0 below one ulp on windows
whose score is ~1e-6.  The CUDA kernel and its plain twin sum in
different orders, so they may differ by one float32 ulp of corr.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chromosight_torch.preprocessing import factorise_kernel

# conv outputs below this magnitude snap to zero (the reference xcorr2
# default, ``chromosight_tpu/ops/convolve.py:494-497``)
DEFAULT_THRESHOLD = 1e-4


def shear_kernel(kernel):
    """(mk, nk) matrix-space kernel -> its (mk, nk+mk-1) band-space
    sheared form ``K_sh[u, v - u + mk - 1] = K[u, v]`` (numpy; a copy of
    ``chromosight_tpu.ops.band.shear_kernel``, whose module loads jax)."""
    kernel = np.asarray(kernel)
    mk, nk = kernel.shape
    sheared = np.zeros((mk, nk + mk - 1), dtype=kernel.dtype)
    for u in range(mk):
        sheared[u, mk - 1 - u : mk - 1 - u + nk] = kernel[u]
    return sheared


def sliding_vector(vec, n_rows, width):
    """Skew view ``out[i, d] = vec[i + d]`` (no copy)."""
    if vec.shape[0] < n_rows + width:
        raise ValueError("vec too short for requested window")
    return vec.unfold(0, width, 1)[:n_rows]


def band_finalize_upload(band, width):
    """Cast an uploaded band to f32 and zero-pad its columns to ``width``."""
    band = band.to(torch.float32)
    pad = width - band.shape[1]
    return F.pad(band, (0, pad)) if pad else band


def band_unpack(mode, arrays, width):
    """The float32 (n, width) raw counts of a count pack on the device
    (``band_upper_counts_auto``'s arrays, uploaded): ``mode`` "u16", the
    band; "u8", the band, then the exceptions' int32 flat indices and
    float32 values; "u4", a uint8 head (n, d0) and a tail of two columns
    per byte (even tail columns in the low nibble, odd ones in the high
    nibble, as the native packer writes them), then the exceptions.  The
    exceptions are written over the unpacked band
    (``chromosight_tpu/ops/band.py:128-233``, without its padding to a
    shape bucket)."""
    if mode == "u16":
        return arrays[0].to(torch.float32)
    *parts, exc_idx, exc_val = arrays
    if mode == "u8":
        band = parts[0].to(torch.float32)
    else:
        head, tail_packed = parts
        n, d0 = head.shape
        tail = torch.stack([tail_packed & 0xF, tail_packed >> 4], dim=-1).reshape(n, -1)
        band = torch.cat([head, tail[:, : width - d0]], dim=1).to(torch.float32)
    band.view(-1)[exc_idx.long()] = exc_val
    return band


def band_weighted(counts, weights):
    """``out[i, d] = float32((c * w[i]) * w[i + d])`` in float64 where the
    count ``c = counts[i, d]`` is > 0, else exactly 0 (a NaN weight
    leaves cells without a pixel at 0): the product and its order of the
    native ``band_scatter_fused``, so the band equals the host-balanced
    one bit for bit, except that a stored count of 0 gives 0 there where
    a NaN weight gives NaN on the host.  ``weights`` are the rows' float64
    weights; ``w[i + d]`` is a view of them, zero past the last row."""
    n, width = counts.shape
    w = weights.to(torch.float64)
    w_j = sliding_vector(torch.cat([w, w.new_zeros(width)]), n, width)
    out = counts.to(torch.float64).mul_(w[:, None]).mul_(w_j)
    return torch.where(counts > 0, out, 0.0).to(torch.float32)


def band_diag_stats(band, detect):
    """Per-diagonal sums and counts of positive pixels between two
    detectable bins (the distance law in band space)."""
    n, width = band.shape
    dev = band.device
    i = torch.arange(n, device=dev)[:, None]
    d = torch.arange(width, device=dev)[None, :]
    det_j = sliding_vector(
        torch.cat([detect, detect.new_zeros(width)]), n, width
    )
    w = (i + d < n) & (band > 0) & detect[:, None] & det_j
    sums = torch.where(w, band, 0).sum(0)
    counts = w.to(band.dtype).sum(0)
    return sums, counts


def band_preprocess(band, detect, max_val, keep_dist, n_diags, zero_nan):
    """Distance law -> detrend -> ``>= max_val`` reset -> band trim ->
    optional NaN zeroing, as ``chromosight_tpu.ops.band.band_preprocess``.

    ``detect`` is the (rows,) bool detectable-bin mask; row padding, if
    any, must be False there."""
    dt = band.dtype
    width = band.shape[1]
    zero = torch.zeros((), dtype=dt, device=band.device)
    sums, counts = band_diag_stats(band, detect)
    law = torch.where(counts > 0, sums / counts, zero)
    d_idx = torch.arange(width, device=band.device)
    law = torch.where(d_idx < n_diags, law, zero)
    out = torch.where(band != 0, band / law[None, :], zero)
    if max_val is not None:
        out = torch.where(out >= max_val, 1.0, out)
    out = torch.where((d_idx <= keep_dist)[None, :], out, zero)
    if zero_nan:
        out = torch.where(torch.isnan(out), zero, out)
    return out


def preprocess_cost(band, detect, *args, **kwargs):
    """(flops, hbm_min_bytes, hbm_unfused_bytes) of ``band_preprocess``
    on a band and detectable-bin mask of these shapes, for
    ``observability.account_dispatch`` (family ``band_preprocess``): the
    FLOPs and unfused bytes of the function itself on the ``meta`` device
    (``observability.plain_cost``), and the band read and written once with
    the mask read once."""
    from chromosight_torch import observability

    width = band.shape[1]
    flops, unfused = observability.plain_cost(
        band_preprocess, band, detect, 10.0, width - 1, width, True
    )
    hbm_min = 2 * band.numel() * band.element_size() + detect.numel() * detect.element_size()
    return flops, hbm_min, unfused


def band_detrend_trim(band, law, max_val, keep_dist):
    """Detrend by a given distance law (one value per diagonal), reset
    values ``>= max_val`` to 1 and zero the columns beyond ``keep_dist``
    (``chromosight_tpu.ops.band.band_detrend_trim``): the staged
    preprocess of ``--smooth-trend`` and ``--dump``."""
    dt = band.dtype
    width = band.shape[1]
    law_cols = law[:width].to(device=band.device, dtype=dt)
    zero = torch.zeros((), dtype=dt, device=band.device)
    out = torch.where(band != 0, band / law_cols[None, :], zero)
    if max_val is not None:
        out = torch.where(out >= max_val, 1.0, out)
    d_idx = torch.arange(width, device=band.device)
    return torch.where((d_idx <= keep_dist)[None, :], out, zero)


def band_zero_missing(band, missing):
    """Zero the pixels of missing rows and columns (``missing``: (rows,)
    bool): what a raw map gets instead of NaN zeroing, as
    ``ContactMap._zero_missing_band`` of the JAX package."""
    width = band.shape[1]
    miss_j = sliding_vector(
        torch.cat([missing, missing.new_zeros(width)]), band.shape[0], width
    )
    return torch.where(missing[:, None] | miss_j, 0.0, band)


def _pad_band(x, mk, nk):
    """(mk-1) rows top and bottom, and the sheared reach ``kh + kw``
    columns on each side, so valid-conv output column c is diagonal c."""
    r = (mk - 1) // 2 + (nk - 1) // 2
    return F.pad(x, (r, r, mk - 1, mk - 1))


def _frame_mask_rules(pi, pd, n, max_dist, kernel_shape):
    """Frame cells counted as missing, in padded band coordinates: the
    top frame, the below-diagonal margin drawn in framed coordinates
    (offset by nk - mk) and the right margin of the bottom rows
    (``chromosight_tpu/ops/band.py:560-578``)."""
    mk, nk = kernel_shape
    big_k = max(mk, nk)
    top_frame = pi < 0
    below_diag = (pd >= mk - nk - big_k) & (pd <= mk - nk - 1)
    right_margin = (pi + pd >= n) & (pi >= n - max_dist - 2)
    return top_frame | below_diag | right_margin


def band_frame(band, missing, kernel_shape, n, max_dist):
    """Framed, padded signal band and missing mask (``_band_frame``).

    ``band`` is (n_pad, W) with n_pad >= n; ``missing`` the (n_pad,) bool
    flags, False on pad rows (masked through ``n``).  Returns f32
    ``(sig_p, mask_p)`` of shape (n_pad + 2(mk-1), W + 2(kh+kw))."""
    n_pad, width = band.shape
    mk, nk = kernel_shape
    dev = band.device
    i = torch.arange(n_pad, device=dev)[:, None]
    d = torch.arange(width, device=dev)[None, :]
    in_matrix = (i + d < n) & (i < n)
    sig = torch.where(in_matrix, band, 0).to(torch.float32)
    miss_j = sliding_vector(
        torch.cat([missing, missing.new_zeros(width)]), n_pad, width
    )
    mask = (missing[:, None] | miss_j) & (d <= max_dist) & in_matrix
    sig_p = _pad_band(sig, mk, nk)
    mask_p = _pad_band(mask.to(torch.float32), mk, nk)
    reach = (mk - 1) // 2 + (nk - 1) // 2
    pi = torch.arange(sig_p.shape[0], device=dev)[:, None] - (mk - 1)
    pd = torch.arange(sig_p.shape[1], device=dev)[None, :] - reach
    frame = _frame_mask_rules(pi, pd, n, max_dist, kernel_shape)
    return sig_p, mask_p.masked_fill_(frame, 1.0)


def conv_kernels(kernel, tsvd=None):
    """The float64 ``(kernel, kernel**2)`` the band engine convolves, or,
    with ``tsvd`` (the share of singular-value energy kept: 0.999 for
    ``--tsvd``), their rank-truncated reconstructions ``lk @ rk`` and
    ``lk2 @ rk2`` (``chromosight_tpu/detection.py:903-912``)."""
    kernel = np.asarray(kernel, dtype=np.float64)
    if tsvd is None:
        return kernel, kernel**2
    lk, rk = factorise_kernel(kernel, prop_info=tsvd)
    lk2, rk2 = factorise_kernel(kernel**2, prop_info=tsvd)
    return lk @ rk, lk2 @ rk2


def kernel_coefficients(kernel, conv_k=None, conv_k2=None):
    """Tap table and sums of a (mk, nk) kernel, in float64 from the
    float64 kernel, as the reference forms them: the planes conv_k / ksize,
    conv_k and conv_k2, the convolved kernels defaulting to K and K**2,
    and ``ksum = sum(K)``, ``k2sum = sum(K * K)``, which always come from
    the kernel itself: with ``--tsvd`` only the tap planes change
    (``chromosight_tpu/ops/band.py:818-819``).  The JAX band engine rounds
    the planes and sums to float32; on a window whose score is ~1e-6 that
    rounding alone moves the score by ~1e-6.

    Returns ``(coef (3, mk, nk), ksum, k2sum)``, float64 CPU tensors."""
    k64 = np.asarray(kernel, dtype=np.float64)
    if k64.ndim != 2:
        raise ValueError(f"kernel must be 2-D, got shape {k64.shape}")
    if conv_k is None:
        conv_k, conv_k2 = k64, k64**2
    planes = [torch.tensor(np.asarray(c, dtype=np.float64)) for c in (conv_k, conv_k2)]
    if any(tuple(p.shape) != k64.shape for p in planes):
        raise ValueError("convolved kernels must have the kernel's shape")
    coef = torch.stack([planes[0] / k64.size, planes[0], planes[1]])
    return coef, torch.tensor(k64.sum()), torch.tensor((k64 * k64).sum())


def kernel_table(kernels, tsvd=None):
    """Tap tables of K same-shape kernels, stacked: ``(coef (K, 3, mk,
    nk), sums (K, 2))`` float64 CPU tensors, ``sums[k] = (ksum,
    k2sum)``."""
    kernels = np.asarray(kernels, dtype=np.float64)
    if kernels.ndim != 3:
        raise ValueError(f"kernels must be (K, mk, nk), got {kernels.shape}")
    coefs, sums = [], []
    for kernel in kernels:
        coef, ksum, k2sum = kernel_coefficients(kernel, *conv_kernels(kernel, tsvd))
        coefs.append(coef)
        sums.append(torch.stack([ksum, k2sum]))
    return torch.stack(coefs), torch.stack(sums)


def _log10p(corr, n_pres):
    """Two-sided log10 p-value of ``corr`` with ``n_pres`` observations
    (Fisher z), through ``log_ndtr`` so it never underflows, in the
    inputs' dtype."""
    z = torch.atanh(corr)
    logtail = torch.special.log_ndtr(-(z * torch.sqrt(n_pres - 3)).abs())
    two = torch.tensor(2.0, dtype=corr.dtype)
    ten = torch.tensor(10.0, dtype=corr.dtype)
    return (logtail + torch.log(two)) / torch.log(ten)


def rounded_pearson(corr, n_pres, log10p=_log10p):
    """(corr, log10 p) rounded to float32 once, the p-value taken from the
    float64 ``corr`` (``log10p`` of it and ``n_pres``)."""
    return corr.float(), log10p(corr, n_pres).float()


# FLOPs of the float64 epilogue (the snaps, ``pearson_algebra`` and the
# log10 p), one per arithmetic operation, snap and special function: per
# output pixel, and per output pixel and kernel
EPILOGUE_FLOPS = (11, 30)


def pearson_flops(pixels, n_k, mk, nk):
    """Logical FLOPs of the missing-corrected Pearson of ``n_k`` (mk, nk)
    kernels at ``pixels`` output pixels, as the plain twin writes the
    function: per pixel a multiply and an add per tap for each kernel's
    three tap sums (2 x 3 x K x mk x nk), mk x nk adds for each of the
    three window sums, and the float64 epilogue (``EPILOGUE_FLOPS``).
    From shapes only, so the count is the same whatever computes it."""
    taps = mk * nk
    per_pixel, per_kernel = EPILOGUE_FLOPS
    return pixels * (6 * n_k * taps + 3 * taps + per_pixel + per_kernel * n_k)


def _trim(corr, n, max_dist, pearson_min):
    """Zero corr outside d <= max_dist and the matrix; candidate mask."""
    dev = corr.device
    oi = torch.arange(corr.shape[-2], device=dev)[:, None]
    od = torch.arange(corr.shape[-1], device=dev)[None, :]
    keep = (od <= max_dist) & (oi < n) & (oi + od < n)
    corr = torch.where(keep, corr, 0.0)
    return corr, (corr >= pearson_min) & (corr != 0)


def snap64(t, threshold, rounded=None):
    """``t`` in float64, 0 where its float32 rounding (``rounded``, by
    default ``t.float()``) is below ``threshold`` in magnitude: the JAX
    package's snap decision, on the value it would hold, with the sum
    itself kept unrounded."""
    rounded = t.float() if rounded is None else rounded
    return torch.where(rounded.abs() < threshold, 0.0, t.double())


def pearson_from_sums(
    s_k, s_x, s_x2, s_m, s_mk, s_mk2, sums, ksize, missing_tol,
    threshold=DEFAULT_THRESHOLD,
):
    """Missing-corrected Pearson (``chromosight_tpu/ops/band.py:611-634``)
    from the six float64 window sums of a set of pixels, each snapped to
    0 below ``threshold`` on its float32 rounding (the signal sums after
    their 1/ksize scaling, decided as the JAX engine's ``ws(x, 1/ksize)``
    multiplies by the float32 reciprocal), then the float64 algebra of
    ``pearson_algebra`` on the unrounded sums (the signal means
    ``s_x / ksize`` and ``s_x2 / ksize``).

    ``s_k``, ``s_mk``, ``s_mk2``: (K, *S) per-kernel sums of K/ksize x,
    K m, K^2 m; ``s_x``, ``s_x2``, ``s_m``: (*S) sums of x, x^2, m;
    ``sums``: (K, 2) (ksum, k2sum).  Returns float64 (corr (K, *S),
    untrimmed, and n_pres (*S))."""
    dev = s_x.device
    inv_ksize = float(1.0 / torch.tensor(float(ksize), dtype=torch.float32))
    per_k = (-1,) + (1,) * s_x.ndim
    sums = sums.to(device=dev, dtype=torch.float64)
    ksum = sums[:, 0].reshape(per_k)
    k2sum = sums[:, 1].reshape(per_k)
    conv_sk, n_miss, conv_mk, conv_mk2 = (
        snap64(t, threshold) for t in (s_k, s_m, s_mk, s_mk2)
    )
    sig_mean0 = snap64(s_x.double() / ksize, threshold, s_x.float() * inv_ksize)
    sig2_mean0 = snap64(s_x2.double() / ksize, threshold, s_x2.float() * inv_ksize)
    return pearson_algebra(
        conv_sk, sig_mean0, sig2_mean0, n_miss, conv_mk, conv_mk2, ksum, k2sum,
        ksize, missing_tol,
    )


def pearson_algebra(
    conv_sk, sig_mean0, sig2_mean0, n_miss, conv_mk, conv_mk2, ksum, k2sum, ksize,
    missing_tol,
):
    """The missing-corrected Pearson in float64 from the snapped float64
    window sums: ``conv_sk`` (K/ksize x), ``sig_mean0`` and
    ``sig2_mean0`` (the means of x and x^2 over the whole window),
    ``n_miss`` (missing pixels), ``conv_mk`` and ``conv_mk2`` (K m, K^2
    m), and the kernel's float64 ``ksum`` and ``k2sum``, all
    broadcastable.  The ``min_pres`` cutoff, the 1e-10 guard, non-finite
    values to 0 and the clamp of ``chromosight_tpu/ops/normxcorr.py:
    205-244``, in the CUDA kernel's order.  Returns float64 (corr,
    n_pres)."""
    n_pres = float(ksize) - n_miss
    kmean_eff = (ksum - conv_mk) / n_pres
    k2mean_eff = (k2sum - conv_mk2) / n_pres
    corr_f = float(ksize) / n_pres
    sig_mean = sig_mean0 * corr_f
    sig2_mean = sig2_mean0 * corr_f
    denom = torch.sqrt(
        (sig2_mean - sig_mean * sig_mean) * (k2mean_eff - kmean_eff * kmean_eff)
    )
    denom = torch.where(n_pres < float(int((1 - missing_tol) * ksize)), 0.0, denom)
    num = (conv_sk - sig_mean * kmean_eff / corr_f) * corr_f
    inv_denom = torch.where(denom.abs() < 1e-10, 0.0, 1.0 / denom)
    out = num * inv_denom
    return torch.where(torch.isfinite(out), out, 0.0).clamp(-1.0, 1.0), n_pres


def _sheared_sums(x, kernels, n_pad):
    """Valid correlation of ``x`` with the sheared form of each (mk, nk)
    kernel on the n_pad output rows,
    ``out[c, i, d] = sum_{u,w} Ksh_c[u, w] x[i + kh + u, d + w]``,
    one matmul per kernel row, in float64, as the CUDA kernel sums."""
    sheared = torch.stack([torch.from_numpy(shear_kernel(k.numpy())) for k in kernels])
    sheared = sheared.to(device=x.device, dtype=torch.float64)
    mk, wk = sheared.shape[1:]
    kh = (mk - 1) // 2
    x = x.double()
    out = 0
    for u in range(mk):
        windows = x[kh + u : kh + u + n_pad].unfold(1, wk, 1)
        out = out + windows @ sheared[:, u].T
    return out.permute(2, 0, 1)


def pearson_reference_multi(
    sig_p,
    mask_p,
    kernels,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    threshold=DEFAULT_THRESHOLD,
    tsvd=None,
):
    """Plain twin of the band Pearson kernel on framed inputs, for K
    same-shape kernels (``chromosight_tpu.ops.band.band_normxcorr_multi``
    after its framing): the three kernel-independent window sums once,
    3K correlations with the sheared tap planes of ``kernel_table``, the
    missing-corrected Pearson, log10-p from the untrimmed corr, then the
    diagonal trim and the candidate threshold.

    ``kernels``: (K, mk, nk).  Returns ``(corr, log10p, cand)``, each
    (K, n_pad, W)."""
    kernels = np.asarray(kernels)
    n_k, mk, nk = kernels.shape
    n_pad = sig_p.shape[0] - 2 * (mk - 1)
    coef, sums = kernel_table(kernels, tsvd)
    ones = torch.ones((mk, nk), dtype=torch.float64)
    sig_sums = _sheared_sums(sig_p, [*coef[:, 0], ones], n_pad)
    s_x2 = _sheared_sums(sig_p.double() ** 2, [ones], n_pad)[0]
    mask_sums = _sheared_sums(mask_p, [ones, *coef[:, 1], *coef[:, 2]], n_pad)
    out, n_pres = pearson_from_sums(
        sig_sums[:n_k],
        sig_sums[n_k],
        s_x2,
        mask_sums[0],
        mask_sums[1 : n_k + 1],
        mask_sums[n_k + 1 :],
        sums,
        mk * nk,
        missing_tol,
        threshold,
    )
    corr, logp = rounded_pearson(out, n_pres)
    corr, cand = _trim(corr, n, max_dist, pearson_min)
    return corr, logp, cand


def pearson_reference(
    sig_p,
    mask_p,
    kernel,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    threshold=DEFAULT_THRESHOLD,
    tsvd=None,
):
    """``pearson_reference_multi`` for one (mk, nk) kernel, the plain twin
    of ``chromosight_tpu/ops/band.py:581-644``.  Returns ``(corr, log10p,
    cand)``, each (n_pad, W)."""
    out = pearson_reference_multi(
        sig_p, mask_p, np.asarray(kernel)[None], n, max_dist, missing_tol,
        pearson_min, threshold, tsvd,
    )
    return tuple(t[0] for t in out)


def band_normxcorr_reference(
    band,
    missing,
    kernel,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    threshold=DEFAULT_THRESHOLD,
    tsvd=None,
):
    """Plain twin of ``chromosight_tpu.ops.band.band_normxcorr``: framing
    then ``pearson_reference``.  Returns ``(corr, log10p, cand)``."""
    sig_p, mask_p = band_frame(band, missing, np.shape(kernel), n, max_dist)
    return pearson_reference(
        sig_p, mask_p, kernel, n, max_dist, missing_tol, pearson_min, threshold,
        tsvd,
    )


def _stencils(planes, device):
    """Flattened sheared forms of (mk, nk) planes: (len, mk * wk) f64."""
    sheared = [torch.from_numpy(shear_kernel(p.numpy())) for p in planes]
    return torch.stack(sheared).flatten(1).to(device=device, dtype=torch.float64)


def band_normxcorr_at_packed(
    band,
    missing,
    rows,
    diags,
    kernels,
    n,
    max_dist,
    missing_tol,
    tsvd=None,
    threshold=DEFAULT_THRESHOLD,
):
    """Pearson and log10-p of K same-shape kernels at T band pixels
    (rows, diags), without sweeping the band, and the raw windows around
    them (``chromosight_tpu/ops/band.py:887-1048``).

    The value at (i, d) depends only on the (mk, nk + mk - 1)
    parallelogram patch of the framed band at rows [i + kh, i + kh + mk)
    and columns [d, d + nk + mk - 1): each of the six window sums is the
    dot product of that patch with a fixed stencil, so one patch gather
    and one matmul per input replace the sweep.  The dots run in float64
    as the sweep kernel's sums do, and the Pearson algebra is
    ``pearson_from_sums``.  Out-of-range requests are clipped to the band
    for the gather; their corr is zeroed (callers mask them).

    ``band``: (rows, W) preprocessed band; ``missing`` its (rows,) flags;
    ``rows``/``diags``: (T,) int64 tensors; ``kernels``: (K, mk, nk).
    Returns a (T, 2K + mk*nk) f32 tensor: K scores, K log10-p, then the
    row-major raw window."""
    kernels = np.asarray(kernels)
    n_k, mk, nk = kernels.shape
    wk = nk + mk - 1
    kh = (mk - 1) // 2
    dev = band.device
    sig_p, mask_p = band_frame(band, missing, (mk, nk), n, max_dist)
    r0 = (rows + kh).clamp(0, sig_p.shape[0] - mk)
    c0 = diags.clamp(0, sig_p.shape[1] - wk)
    ri = r0[:, None, None] + torch.arange(mk, device=dev)[None, :, None]
    ci = c0[:, None, None] + torch.arange(wk, device=dev)[None, None, :]
    t = rows.shape[0]
    patch = sig_p[ri, ci].reshape(t, mk * wk).double()
    mpatch = mask_p[ri, ci].reshape(t, mk * wk).double()
    coef, sums = kernel_table(kernels, tsvd)
    ones = torch.ones((mk, nk), dtype=torch.float64)
    sig_dots = patch @ _stencils([*coef[:, 0], ones], dev).T
    s_x2 = (patch * patch) @ _stencils([ones], dev)[0]
    mask_dots = mpatch @ _stencils([ones, *coef[:, 1], *coef[:, 2]], dev).T
    out, n_pres = pearson_from_sums(
        sig_dots[:, :n_k].T,
        sig_dots[:, n_k],
        s_x2,
        mask_dots[:, 0],
        mask_dots[:, 1 : n_k + 1].T,
        mask_dots[:, n_k + 1 :].T,
        sums,
        mk * nk,
        missing_tol,
        threshold,
    )
    out, logp = rounded_pearson(out, n_pres)
    keep = (diags <= max_dist) & (rows < n) & (rows + diags < n)
    corr = torch.where(keep, out, 0.0)
    wins = gather_windows(band, rows, rows + diags, mk, nk).reshape(t, mk * nk)
    return torch.cat([corr.T, logp.T, wins], dim=1)


def at_cost(band, missing, rows, diags, kernels):
    """(flops, hbm_min_bytes, hbm_unfused_bytes) of one
    ``band_normxcorr_at_packed`` call at these shapes, for
    ``observability.account_dispatch`` (family ``band_normxcorr_at``):
    ``pearson_flops`` at the T requested pixels; the band, flags, pixel
    indices, float64 tap table and the packed (T, 2K + mk*nk) float32
    output; and the plain function's unfused bytes on the ``meta`` device
    (``observability.plain_cost``)."""
    from chromosight_torch import observability

    n_k, mk, nk = np.shape(kernels)
    t = rows.shape[0]
    inputs = sum(x.numel() * x.element_size() for x in (band, missing, rows, diags))
    hbm_min = inputs + n_k * (3 * mk * nk + 2) * 8 + t * (2 * n_k + mk * nk) * 4
    _, unfused = observability.plain_cost(
        band_normxcorr_at_packed, band, missing, rows, diags, np.asarray(kernels),
        band.shape[0], band.shape[1] - 1, 0.5,
    )
    return pearson_flops(t, n_k, mk, nk), hbm_min, unfused


def extract_candidates(corr, cand):
    """Row-major ``(rows, diags, values)`` of the candidate pixels."""
    ii, dd = torch.nonzero(cand, as_tuple=True)
    return ii, dd, corr[ii, dd]


def gather_windows(band, p1, p2, win_h, win_w):
    """(n_pat, win_h, win_w) raw windows around matrix coords (p1, p2),
    zero outside the band and the matrix."""
    n, width = band.shape
    half_h, half_w = win_h // 2 + 1, win_w // 2 + 1
    dev = band.device
    r = p1[:, None] - half_h + 1 + torch.arange(win_h, device=dev)[None, :]
    c = p2[:, None] - half_w + 1 + torch.arange(win_w, device=dev)[None, :]
    rr = r[:, :, None]
    cc = c[:, None, :]
    d = cc - rr
    ok = (rr >= 0) & (rr < n) & (d >= 0) & (d < width)
    vals = band[rr.clamp(0, n - 1), d.clamp(0, width - 1)]
    return torch.where(ok, vals, 0.0)


def gather_tail(corr, logp, band, p1, dsc, win_h, win_w):
    """Scores, log10-p and raw windows at band coords (p1, p1 + dsc) in one
    (n_pat, 2 + win_h * win_w) tensor (``gather_tail_packed``)."""
    r = p1.clamp(0, corr.shape[0] - 1)
    d = dsc.clamp(0, corr.shape[1] - 1)
    pair = torch.stack([corr[r, d], logp[r, d]], dim=1)
    wins = gather_windows(band, p1, p1 + dsc, win_h, win_w)
    return torch.cat([pair, wins.reshape(p1.shape[0], win_h * win_w)], dim=1)
