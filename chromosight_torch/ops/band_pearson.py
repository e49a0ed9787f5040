"""The fused band Pearson: wrapper of the CUDA kernel and its CPU twins.

``band_pearson`` replaces ``chromosight_tpu/ops/pallas_band.py``'s
``_fused_kernel`` and its XLA epilogue (``band_normxcorr_pallas``).  On
framed inputs (``ops.band.band_frame``) it returns ``(corr, log10p,
cand)``:

* a CPU tensor takes the plain twin, ``ops.band.pearson_reference``;
* a CUDA tensor launches ``csrc/band_pearson.cu`` or raises.

``band_pearson_emulated`` is a vectorised transcription of the CUDA
kernel's own arithmetic (one loop over the mk*nk taps, the same
coefficient table, the same output indexing and epilogue), so the CPU
tests hold the kernel's addressing against the JAX package.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from chromosight_torch.ops import _build
from chromosight_torch.ops.band import (
    DEFAULT_THRESHOLD,
    kernel_coefficients,
    pearson_reference,
)

# Launches of the CUDA kernel in this process (see module docstring).
LAUNCHES = 0

_ARGTYPES = (
    [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 7
    + [ctypes.c_float] * 5
    + [ctypes.c_void_p] * 4
)


def _geometry(sig_p, mask_p, kernel):
    """Validate the framed inputs; returns (mk, nk, n_pad, w_out)."""
    for name, t in (("sig_p", sig_p), ("mask_p", mask_p)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if sig_p.shape != mask_p.shape or sig_p.device != mask_p.device:
        raise ValueError("sig_p and mask_p differ in shape or device")
    if np.ndim(kernel) != 2:
        raise ValueError("kernel must be a 2-D array")
    mk, nk = np.shape(kernel)
    n_pad = sig_p.shape[0] - 2 * (mk - 1)
    w_out = sig_p.shape[1] - 2 * ((mk - 1) // 2 + (nk - 1) // 2)
    if n_pad <= 0 or w_out <= 0 or w_out + mk + nk - 2 > sig_p.shape[1]:
        raise ValueError(
            f"framed shape {tuple(sig_p.shape)} does not fit a {mk}x{nk} "
            "kernel (odd kernel sides expected)"
        )
    return mk, nk, n_pad, w_out


def band_pearson(
    sig_p,
    mask_p,
    kernel,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    threshold=DEFAULT_THRESHOLD,
):
    """Missing-corrected band Pearson, log10-p and candidates.

    ``sig_p``/``mask_p``: framed (n_pad + 2(mk-1), W + 2(kh+kw)) float32
    tensors; ``kernel``: (mk, nk) host array; ``n`` logical rows,
    ``max_dist`` the diagonal trim, ``missing_tol`` the tolerated missing
    share of a window, ``pearson_min`` the candidate threshold.  Returns
    ``(corr, log10p, cand)``, each (n_pad, W), cand bool."""
    global LAUNCHES
    mk, nk, n_pad, w_out = _geometry(sig_p, mask_p, kernel)
    if sig_p.device.type == "cpu":
        return pearson_reference(
            sig_p, mask_p, kernel, n, max_dist, missing_tol, pearson_min,
            threshold,
        )
    if sig_p.device.type != "cuda":
        raise ValueError(f"band_pearson runs on cpu or cuda, not {sig_p.device}")
    lib = _build.load()
    fn = lib.band_pearson_f32
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    coef, ksum, k2sum = kernel_coefficients(kernel)
    coef = coef.to(sig_p.device)
    corr = torch.empty((n_pad, w_out), dtype=torch.float32, device=sig_p.device)
    logp = torch.empty_like(corr)
    cand = torch.empty((n_pad, w_out), dtype=torch.uint8, device=sig_p.device)
    rc = fn(
        sig_p.data_ptr(),
        mask_p.data_ptr(),
        coef.data_ptr(),
        n_pad,
        w_out,
        sig_p.shape[1],
        mk,
        nk,
        int(n),
        int(max_dist),
        float(ksum),
        float(k2sum),
        float(int((1 - missing_tol) * mk * nk)),
        float(threshold),
        float(pearson_min),
        corr.data_ptr(),
        logp.data_ptr(),
        cand.data_ptr(),
        torch.cuda.current_stream(sig_p.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"band_pearson kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return corr, logp, cand.view(torch.bool)


def log10_two_sided(a):
    """log10 of the two-sided normal tail 2 Phi(-a) for a >= 0, in the
    kernel's form: log_ndtr(-a) = log(0.5 erfcx(a / sqrt2)) - a^2 / 2,
    which does not underflow where Phi(-a) does."""
    tail = torch.log(0.5 * torch.special.erfcx(a * (1 / math.sqrt(2)))) - 0.5 * a * a
    two = torch.tensor(2.0, dtype=a.dtype)
    ten = torch.tensor(10.0, dtype=a.dtype)
    return (tail + torch.log(two)) / torch.log(ten)


def band_pearson_emulated(
    sig_p,
    mask_p,
    kernel,
    n,
    max_dist,
    missing_tol,
    pearson_min,
    threshold=DEFAULT_THRESHOLD,
):
    """``band_pearson``'s CUDA arithmetic on CPU tensors: the same single
    (u, v) tap loop over ``sig[i + kh + u, d + mk-1-u + v]`` into float64
    sums, the same coefficient table, snaps, float32 Pearson algebra,
    erfcx p-value, trim and candidate rule, vectorised over the
    (n_pad, W) output pixels."""
    mk, nk, n_pad, w_out = _geometry(sig_p, mask_p, kernel)
    coef, ksum, k2sum = kernel_coefficients(kernel)
    ksize = float(mk * nk)
    inv_ksize = float(1.0 / torch.tensor(ksize, dtype=torch.float32))
    kh = (mk - 1) // 2
    sig64, mask64, coef64 = sig_p.double(), mask_p.double(), coef.double()
    s_k, s_x, s_x2, s_m, s_mk, s_mk2 = (
        torch.zeros((n_pad, w_out), dtype=torch.float64) for _ in range(6)
    )
    for u in range(mk):
        for v in range(nk):
            col = mk - 1 - u + v
            x = sig64[kh + u : kh + u + n_pad, col : col + w_out]
            m = mask64[kh + u : kh + u + n_pad, col : col + w_out]
            s_k += coef64[0, u, v] * x
            s_x += x
            s_x2 += x * x
            s_m += m
            s_mk += coef64[1, u, v] * m
            s_mk2 += coef64[2, u, v] * m

    def snap(t):
        t = t.float()
        return torch.where(t.abs() < threshold, 0.0, t)

    conv_sk, n_miss, conv_mk, conv_mk2 = map(snap, (s_k, s_m, s_mk, s_mk2))
    sig_mean0 = snap(s_x.float() * inv_ksize)
    sig2_mean0 = snap(s_x2.float() * inv_ksize)
    n_pres = ksize - n_miss
    kmean_eff = (float(ksum) - conv_mk) / n_pres
    k2mean_eff = (float(k2sum) - conv_mk2) / n_pres
    # tensor numerator: torch computes `scalar / tensor` as a reciprocal
    # times the scalar, which rounds differently from the kernel's division
    corr_f = torch.tensor(ksize, dtype=torch.float32) / n_pres
    sig_mean = sig_mean0 * corr_f
    sig2_mean = sig2_mean0 * corr_f
    denom = torch.sqrt(
        (sig2_mean - sig_mean * sig_mean) * (k2mean_eff - kmean_eff * kmean_eff)
    )
    denom = torch.where(n_pres < float(int((1 - missing_tol) * mk * nk)), 0.0, denom)
    num = (conv_sk - sig_mean * kmean_eff / corr_f) * corr_f
    inv_denom = torch.where(denom.abs() < 1e-10, 0.0, 1.0 / denom)
    out = num * inv_denom
    out = torch.where(torch.isfinite(out), out, 0.0).clamp(-1.0, 1.0)
    logp = log10_two_sided((torch.atanh(out) * torch.sqrt(n_pres - 3.0)).abs())
    oi = torch.arange(n_pad)[:, None]
    od = torch.arange(w_out)[None, :]
    keep = (od <= max_dist) & (oi < n) & (oi + od < n)
    corr = torch.where(keep, out, 0.0)
    return corr, logp, (corr >= pearson_min) & (corr != 0)
