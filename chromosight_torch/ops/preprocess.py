"""Dense preprocessing on the device: distance law, detrending, trimming.

Counterpart of ``chromosight_tpu/ops/preprocess.py``: the intra
preprocessing of maps without a bounded scan distance (held whole and
dense), and the median scale of dense inter maps.  Every function takes
tensors on any device and computes in the input's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from chromosight_torch.device import download
from chromosight_torch.ops.band import sliding_vector
from chromosight_torch.preprocessing import pava_decreasing


def diag_sums_counts(mat, detect, n_diags):
    """Per-diagonal sums and counts of the positive pixels between two
    detectable bins, over upper diagonals 0..n_diags-1 of a dense (n, n)
    map (``chromosight_tpu/ops/preprocess.py:24-53``)."""
    n = mat.shape[0]
    dev = mat.device
    i = torch.arange(n, device=dev)[:, None]
    d = torch.arange(n_diags, device=dev)[None, :]
    j = i + d
    vals = torch.gather(mat, 1, j.clamp(max=n - 1))
    det_j = sliding_vector(torch.cat([detect, detect.new_zeros(n_diags)]), n, n_diags)
    w = (j < n) & (vals > 0) & detect[:, None] & det_j
    return torch.where(w, vals, 0).sum(0), w.to(mat.dtype).sum(0)


def distance_law_dense(mat, detect, n_diags, smooth=False):
    """The distance law of a dense intra map as a float64 numpy vector of
    length n (0 beyond ``n_diags``), optionally fitted non-increasing
    (``chromosight_tpu/ops/preprocess.py:56-78``)."""
    n = mat.shape[0]
    n_diags = int(min(n, n_diags))
    sums, counts = diag_sums_counts(mat, detect, n_diags)
    # fitted on the host: a download the JAX package does not count
    sums = download(sums).astype(np.float64)
    counts = download(counts).astype(np.float64)
    law = np.zeros(n)
    with np.errstate(invalid="ignore", divide="ignore"):
        law[:n_diags] = sums / counts
    if smooth and n > 2:
        law[~np.isfinite(law)] = 0
        law = pava_decreasing(law)
    return law


def _distance(n, device):
    i = torch.arange(n, device=device)
    return (i[None, :] - i[:, None]).abs()


def detrend_dense(mat, law, max_val):
    """Each non-zero pixel divided by the law at |i - j|, values >=
    ``max_val`` reset to 1; NaN pixels stay NaN
    (``chromosight_tpu/ops/preprocess.py:81-98``)."""
    law_d = law.to(device=mat.device, dtype=mat.dtype)[_distance(mat.shape[0], mat.device)]
    out = torch.where(mat != 0, mat / law_d, 0.0)
    if max_val is not None:
        out = torch.where(out >= max_val, 1.0, out)
    return out


def detrend_trim_dense(mat, law, max_val, keep_dist):
    """``detrend_dense`` then upper diagonals 0..keep_dist kept
    (``chromosight_tpu/ops/preprocess.py:101-120``)."""
    return diag_trim_dense(detrend_dense(mat, law, max_val), keep_dist)


def diag_trim_dense(mat, n_keep):
    """Upper diagonals 0..n_keep of a dense map kept, the rest zero
    (``n_keep`` None: every upper diagonal)."""
    dev = mat.device
    d = torch.arange(mat.shape[1], device=dev)[None, :] - torch.arange(mat.shape[0], device=dev)[:, None]
    keep = d >= 0
    if n_keep is not None:
        keep &= d <= n_keep
    return torch.where(keep, mat, 0.0)


def inter_median_scale(mat, structure):
    """An inter map divided by the median of its stored pixels
    (``structure``, bool), NaN pixels zeroed first and counted
    (``chromosight_tpu/ops/preprocess.py:132-152``)."""
    mat = torch.where(torch.isnan(mat), 0.0, mat)
    svals = torch.sort(mat[structure]).values
    n = svals.numel()
    med = (svals[(n - 1) // 2] + svals[n // 2]) / 2
    return mat / med
