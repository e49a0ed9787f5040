"""Host helpers for bins, the distance law and kernels.

The port's copies of the four functions of
``chromosight_tpu/preprocessing.py`` that it calls: ``missing_flags``,
``pava_decreasing``, ``resize_kernel`` and ``factorise_kernel``, with the
same arithmetic.  scipy is imported by ``resize_kernel`` when it runs.
"""

from __future__ import annotations

import sys

import numpy as np


def missing_flags(valid, size):
    """Boolean missing-bin vector (True = missing) from valid indices."""
    flags = np.ones(size, dtype=bool)
    valid = np.asarray(valid, dtype=np.int64)
    if valid.size:
        flags[valid[(valid >= 0) & (valid < size)]] = False
    return flags


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
