"""The fused band Pearson: wrapper of the CUDA kernel and its CPU twins.

``band_pearson`` replaces ``chromosight_tpu/ops/pallas_band.py``'s
``_fused_kernel`` and its XLA epilogue (``band_normxcorr_pallas``).  On
framed inputs (``ops.band.band_frame``) it returns ``(corr, log10p,
cand)``:

* a CPU tensor takes the plain twin, ``ops.band.pearson_reference_multi``;
* a CUDA tensor launches ``csrc/band_pearson.cu`` or raises.

It runs one kernel (single-kernel mode) or a stack of K same-shape
kernels (K-kernel mode, up to ``MAX_K`` per launch: borders' three
kernels in one pass over the band), with the kernels' own taps or, for
``--tsvd``, their rank-truncated reconstructions.

``band_pearson_emulated`` is a vectorised transcription of the CUDA
kernel's own arithmetic (float64 taps in (u, v) order, separable window
sums, the same output indexing and float64 epilogue), so the CPU tests
hold the kernel's arithmetic against the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from chromosight_torch import observability
from chromosight_torch.ops import _build
from chromosight_torch.ops.band import (
    DEFAULT_THRESHOLD,
    kernel_table,
    pearson_flops,
    pearson_from_sums,
    pearson_reference_multi,
    rounded_pearson,
)

# Launches of the CUDA kernel in this process, in single-kernel mode (a
# 2-D kernel) and in K-kernel mode (a (K, mk, nk) stack).  The
# scheduler's workers launch from several threads: counts and the tap
# table cache change under _LOCK.
LAUNCHES = 0
LAUNCHES_MULTI = 0
_LOCK = threading.Lock()

# Kernels per launch; larger stacks split into several launches (fewer
# for the large square kernels of the compile-time instances, whose tap
# tables must fit the constant bank: ``band_pearson_max_kernels`` of the
# library).
MAX_K = 8

_ARGTYPES = (
    [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 8
    + [ctypes.c_float] * 3
    + [ctypes.c_void_p] * 4
)


def _geometry(sig_p, mask_p, kernels):
    """Validate the framed inputs and a (K, mk, nk) kernel stack; returns
    (mk, nk, n_pad, w_out)."""
    for name, t in (("sig_p", sig_p), ("mask_p", mask_p)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if sig_p.shape != mask_p.shape or sig_p.device != mask_p.device:
        raise ValueError("sig_p and mask_p differ in shape or device")
    if kernels.ndim != 3 or len(kernels) == 0:
        raise ValueError("kernel must be a 2-D array or a (K, mk, nk) stack")
    _, mk, nk = kernels.shape
    n_pad = sig_p.shape[0] - 2 * (mk - 1)
    w_out = sig_p.shape[1] - 2 * ((mk - 1) // 2 + (nk - 1) // 2)
    if n_pad <= 0 or w_out <= 0 or w_out + mk + nk - 2 > sig_p.shape[1]:
        raise ValueError(
            f"framed shape {tuple(sig_p.shape)} does not fit a {mk}x{nk} "
            "kernel (odd kernel sides expected)"
        )
    return mk, nk, n_pad, w_out


@functools.lru_cache(maxsize=1)
def _lib():
    """The kernel library, its entries' argument types declared."""
    lib = _build.load()
    lib.band_pearson_f32.argtypes = _ARGTYPES
    lib.band_pearson_f32.restype = ctypes.c_int
    lib.band_pearson_max_kernels.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=32)
def _cached_table(kernel_bytes, shape, tsvd, device):
    kernels = np.frombuffer(kernel_bytes, dtype=np.float64).reshape(shape)
    coef, sums = kernel_table(kernels, tsvd)
    return coef.double().to(device), sums.to(device)


def device_table(kernels, tsvd, device):
    """The kernel's tap table on ``device``: ``kernel_table(kernels,
    tsvd)``: the float64 taps and (ksum, k2sum) sums.  Built and uploaded once per kernel stack: later
    launches (every chromosome of a genome, every timed repeat) reuse it;
    each device has its own.  The tensors are shared; never write them."""
    k64 = np.ascontiguousarray(kernels, dtype=np.float64)
    with _LOCK:
        return _cached_table(k64.tobytes(), k64.shape, tsvd, device)


def _stack(kernel):
    """(kernels (K, mk, nk), multi): a 2-D kernel becomes a stack of one."""
    kernels = np.asarray(kernel)
    if kernels.ndim == 2:
        return kernels[None], False
    return kernels, True


def band_cost(sig_p, mask_p, kernels):
    """(flops, hbm_min_bytes, hbm_unfused_bytes) of one ``band_pearson``
    call on framed inputs of these shapes and a (K, mk, nk) stack, for
    ``observability.account_dispatch`` (families ``band_normxcorr``, K =
    1, and ``band_normxcorr_multi``):

    * flops: ``pearson_flops`` over the (n_pad, W) output pixels;
    * hbm_min_bytes: the two float32 inputs, the float64 tap table and
      sums, and the K planes of float32 corr and log10 p and byte
      candidates;
    * hbm_unfused_bytes: the plain twin's inputs and every tensor it
      writes (``observability.plain_cost`` of ``pearson_reference_multi``).

    This count reads the shapes only: every tap of every kernel at every
    pixel.  PERF.md's bound of the kernel counts the work of the data
    instead (FMAs over non-zero x and set mask bits, window sums as the
    separable sums): on chr1 of the 13 x 48,000-bin genome with loops
    (48,000 x 418 pixels, K = 1, 17 x 17) this count is 5.30e10 FLOP,
    0.79 ms at 66.9 TFLOP/s, where the bound is 0.2332 ms."""
    n_k, mk, nk = np.shape(kernels)
    n_pad = sig_p.shape[0] - 2 * (mk - 1)
    w_out = sig_p.shape[1] - 2 * ((mk - 1) // 2 + (nk - 1) // 2)
    pixels = n_pad * w_out
    hbm_min = 2 * 4 * sig_p.numel() + n_k * (3 * mk * nk + 2) * 8 + n_k * pixels * 9
    _, unfused = observability.plain_cost(
        pearson_reference_multi, sig_p, mask_p, np.asarray(kernels), n_pad, w_out,
        0.5, 0.3,
    )
    return pearson_flops(pixels, n_k, mk, nk), hbm_min, unfused


def band_pearson(
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
    """Missing-corrected band Pearson, log10-p and candidates.

    ``sig_p``/``mask_p``: framed (n_pad + 2(mk-1), W + 2(kh+kw)) float32
    tensors; ``kernel``: an (mk, nk) host array (single-kernel mode,
    maps of shape (n_pad, W)) or a (K, mk, nk) stack of same-shape kernels
    (K-kernel mode, maps of shape (K, n_pad, W), slice k equal bit for bit
    to single-kernel mode on kernel k); ``n`` logical rows, ``max_dist``
    the diagonal trim, ``missing_tol`` the tolerated missing share of a
    window, ``pearson_min`` the candidate threshold; ``tsvd`` the energy
    share of ``--tsvd`` (convolve rank-truncated kernels) or None.
    Returns ``(corr, log10p, cand)``, cand bool."""
    global LAUNCHES, LAUNCHES_MULTI
    kernels, multi = _stack(kernel)
    mk, nk, n_pad, w_out = _geometry(sig_p, mask_p, kernels)
    family = "band_normxcorr" if len(kernels) == 1 else "band_normxcorr_multi"
    observability.account_dispatch(family, band_cost, sig_p, mask_p, kernels)
    if sig_p.device.type == "cpu":
        out = pearson_reference_multi(
            sig_p, mask_p, kernels, n, max_dist, missing_tol, pearson_min,
            threshold, tsvd,
        )
        return out if multi else tuple(t[0] for t in out)
    if sig_p.device.type != "cuda":
        raise ValueError(f"band_pearson runs on cpu or cuda, not {sig_p.device}")
    lib = _lib()
    fn = lib.band_pearson_f32
    per_launch = lib.band_pearson_max_kernels(mk, nk)
    dev = sig_p.device
    coef, sums = device_table(kernels, tsvd, dev)
    n_k = len(kernels)
    corr = torch.empty((n_k, n_pad, w_out), dtype=torch.float32, device=dev)
    logp = torch.empty_like(corr)
    cand = torch.empty((n_k, n_pad, w_out), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for k0 in range(0, n_k, per_launch):
            k1 = min(k0 + per_launch, n_k)
            rc = fn(
                sig_p.data_ptr(),
                mask_p.data_ptr(),
                coef[k0:k1].data_ptr(),
                sums[k0:k1].data_ptr(),
                k1 - k0,
                n_pad,
                w_out,
                sig_p.shape[1],
                mk,
                nk,
                int(n),
                int(max_dist),
                float(int((1 - missing_tol) * mk * nk)),
                float(threshold),
                float(pearson_min),
                corr[k0].data_ptr(),
                logp[k0].data_ptr(),
                cand[k0].data_ptr(),
                stream,
            )
            if rc != 0:
                raise RuntimeError(
                    f"band_pearson kernel launch failed: cudaError {rc}"
                )
            with _LOCK:
                if multi:
                    LAUNCHES_MULTI += 1
                else:
                    LAUNCHES += 1
    out = (corr, logp, cand.view(torch.bool))
    return out if multi else tuple(t[0] for t in out)


def log10_two_sided(a):
    """log10 of the two-sided normal tail 2 Phi(-a) for a >= 0, in the
    kernel's form: log_ndtr(-a) = log(0.5 erfcx(a / sqrt2)) - a^2 / 2,
    which does not underflow where Phi(-a) does."""
    tail = torch.log(0.5 * torch.special.erfcx(a * (1 / math.sqrt(2)))) - 0.5 * a * a
    two = torch.tensor(2.0, dtype=a.dtype)
    ten = torch.tensor(10.0, dtype=a.dtype)
    return (tail + torch.log(two)) / torch.log(ten)


def log10_pvalue(corr, n_obs):
    """Two-sided log10 p-value of ``corr`` with ``n_obs`` observations
    (Fisher z), without underflow, in the inputs' dtype: the kernel's
    ``log10_two_sided`` of |atanh(corr) sqrt(n_obs - 3)|."""
    return log10_two_sided((torch.atanh(corr) * torch.sqrt(n_obs - 3)).abs())


def separable_window_sums(sig64, mask64, mk, nk, n_pad, w_out):
    """The kernel's three window sums (x, x^2, m) of every output pixel,
    in float64 and in its order: anti-diagonal sums
    ``A[i][c] = sum_u x[i + kh + u][c + mk-1-u]`` over u, then
    ``sum_v A[i][d + v]`` over v."""
    kh = (mk - 1) // 2
    cols = w_out + nk - 1
    out = []
    for plane in (sig64, sig64 * sig64, mask64):
        diag = plane[kh : kh + n_pad, mk - 1 : mk - 1 + cols]
        for u in range(1, mk):
            diag = diag + plane[kh + u : kh + u + n_pad, mk - 1 - u : mk - 1 - u + cols]
        total = diag[:, 0:w_out]
        for v in range(1, nk):
            total = total + diag[:, v : v + w_out]
        out.append(total)
    return tuple(out)


def band_pearson_emulated(
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
    """``band_pearson``'s CUDA arithmetic on CPU tensors: per kernel the
    three tap sums over ``sig[i + kh + u, d + mk-1-u + v]`` (and the
    mask) in (u, v) order with float64 taps (multiply-then-add, where the
    kernel fuses them: the sums may differ in their last bits), the
    separable window sums of ``separable_window_sums``, then the same
    snaps, float64 Pearson algebra and erfcx p-value, one rounding to
    float32, trim and candidate rule, vectorised over the (n_pad, W)
    output pixels.  Takes and
    returns what ``band_pearson`` does, in single- or K-kernel mode."""
    kernels, multi = _stack(kernel)
    mk, nk, n_pad, w_out = _geometry(sig_p, mask_p, kernels)
    coef, sums = kernel_table(kernels, tsvd)
    n_k = len(kernels)
    kh = (mk - 1) // 2
    sig64, mask64, coef64 = sig_p.double(), mask_p.double(), coef.double()
    s_k, s_mk, s_mk2 = (
        torch.zeros((n_k, n_pad, w_out), dtype=torch.float64) for _ in range(3)
    )
    for u in range(mk):
        for v in range(nk):
            col = mk - 1 - u + v
            x = sig64[kh + u : kh + u + n_pad, col : col + w_out]
            m = mask64[kh + u : kh + u + n_pad, col : col + w_out]
            taps = coef64[:, :, u, v, None, None]
            s_k += taps[:, 0] * x
            s_mk += taps[:, 1] * m
            s_mk2 += taps[:, 2] * m
    s_x, s_x2, s_m = separable_window_sums(sig64, mask64, mk, nk, n_pad, w_out)
    out, n_pres = pearson_from_sums(
        s_k, s_x, s_x2, s_m, s_mk, s_mk2, sums, mk * nk, missing_tol, threshold
    )
    out, logp = rounded_pearson(out, n_pres, log10_pvalue)
    oi = torch.arange(n_pad)[:, None]
    od = torch.arange(w_out)[None, :]
    keep = (od <= max_dist) & (oi < n) & (oi + od < n)
    corr = torch.where(keep, out, 0.0)
    res = (corr, logp, (corr >= pearson_min) & (corr != 0))
    return res if multi else tuple(t[0] for t in res)
