"""Valid-mode 2-D cross-correlations on dense tensors.

Counterpart of ``chromosight_tpu/ops/convolve.py``, without its MXU
formulations (``_row_toeplitz``, ``conv2d_valid_phase``,
``conv2d_valid_chunked``, ``conv2d_valid_multik``), which served the TPU:
here a correlation is one ``torch.nn.functional.conv2d`` (no kernel flip,
TF32 off, see ``chromosight_torch.device``), or, for blocks of a sparse
map, a scatter-add of each stored entry's products
(``window_sums_entries``).

Every function takes a (H, W) tensor or a (B, H, W) stack and sums in
float64: the float32 input is converted exactly, so the sums of a few
hundred products are exact or nearly so, and the callers round them to
float32 once.  The reference's quirks kept for parity: outputs below the
threshold (1e-4) snap to zero, and a valid-mode output is zero-padded back
to the input's shape with (k-1)//2 margins.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from chromosight_torch.ops.band import DEFAULT_THRESHOLD

__all__ = [
    "DEFAULT_THRESHOLD",
    "conv2d_valid",
    "conv2d_valid_separable",
    "pad_margins",
    "window_sum_valid",
    "window_sums_entries",
    "xcorr2",
]

# (entry, tap) pairs per scatter-add step of ``window_sums_entries``
ENTRY_CHUNK = 1 << 24


def _nchw(signal):
    """(N, 1, H, W) float64 view of a (H, W) or (B, H, W) tensor, and
    whether it had a batch axis."""
    batched = signal.ndim == 3
    x = signal if batched else signal[None]
    return x.to(torch.float64)[:, None], batched


def _unbatch(out, batched):
    out = out[:, 0]
    return out if batched else out[0]


def conv2d_valid(signal, kernel):
    """Valid-mode cross-correlation of ``signal`` ((H, W) or (B, H, W))
    with an (mk, nk) kernel, summed in float64: (..., H-mk+1, W-nk+1)."""
    x, batched = _nchw(signal)
    w = torch.as_tensor(kernel).to(device=x.device, dtype=torch.float64)
    return _unbatch(F.conv2d(x, w[None, None]), batched)


def window_sums_entries(slot, rows, cols, values, shape, kernel):
    """The Pearson's float64 planes of a (B, H, W) stack of blocks that
    are zero but for the entries ``values`` at (``slot``, ``rows``,
    ``cols``): the valid-mode correlation with ``kernel`` and the window
    sums of x and x^2 (what ``conv2d_valid`` and ``window_sum_valid`` give
    on the blocks).  Each entry scatter-adds its contributions to the
    outputs whose window holds it, so the work is entries x taps instead
    of B x outputs x taps.  Returns three (B, H-mk+1, W-nk+1) tensors."""
    b, h, w = shape
    dev = values.device
    taps = torch.as_tensor(kernel).to(device=dev, dtype=torch.float64)
    mk, nk = taps.shape
    h_out, w_out = h - mk + 1, w - nk + 1
    out = torch.zeros((b * h_out * w_out, 3), dtype=torch.float64, device=dev)
    x = values.to(torch.float64)
    per_entry = torch.stack([x, x, x * x], 1)
    per_tap = torch.stack([taps.flatten(), torch.ones_like(taps.flatten()),
                           torch.ones_like(taps.flatten())], 1)
    u = torch.arange(mk, device=dev).repeat_interleave(nk)
    v = torch.arange(nk, device=dev).repeat(mk)
    # whole tap rows per step, about ENTRY_CHUNK (entry, tap) pairs each
    step = nk * max(1, ENTRY_CHUNK // max(1, len(x) * nk))
    for t in range(0, mk * nk, step):
        i = rows[:, None] - u[None, t : t + step]
        j = cols[:, None] - v[None, t : t + step]
        ok = (i >= 0) & (i < h_out) & (j >= 0) & (j < w_out)
        flat = (slot[:, None] * h_out + i) * w_out + j
        out.index_add_(0, flat[ok], (per_entry[:, None, :] * per_tap[None, t : t + step])[ok])
    out = out.view(b, h_out, w_out, 3)
    return out[..., 0], out[..., 1], out[..., 2]


def window_sum_valid(signal, window_shape):
    """Valid-mode sliding-window sum (a correlation with ones), as two
    one-dimensional passes, in float64."""
    mk, nk = window_shape
    x, batched = _nchw(signal)
    rows = F.conv2d(x, x.new_ones((1, 1, mk, 1)))
    return _unbatch(F.conv2d(rows, x.new_ones((1, 1, 1, nk))), batched)


def conv2d_valid_separable(signal, left, right):
    """Valid-mode correlation with the rank-r kernel ``left @ right``
    (``left`` (mk, r), ``right`` (r, nk): the ``--tsvd`` factors), as r
    column passes then one channel-contracting row pass, in float64."""
    x, batched = _nchw(signal)
    left = torch.as_tensor(left).to(device=x.device, dtype=torch.float64)
    right = torch.as_tensor(right).to(device=x.device, dtype=torch.float64)
    mid = F.conv2d(x, left.T[:, None, :, None])
    return _unbatch(F.conv2d(mid, right[None, :, None, :]), batched)


def snap_small(x, threshold):
    """Values below ``threshold`` in magnitude become 0 (None: no snap)."""
    if threshold is None:
        return x
    return torch.where(x.abs() < threshold, torch.zeros((), dtype=x.dtype, device=x.device), x)


def pad_margins(valid_out, kernel_shape, value=0.0):
    """Pad a valid-mode output back to the signal's shape with (k-1)//2
    margins on each side (``chromosight_tpu/ops/convolve.py:500``)."""
    mk, nk = kernel_shape
    kh, kw = (mk - 1) // 2, (nk - 1) // 2
    return F.pad(valid_out, (kw, kw, kh, kh), value=value)


def xcorr2(signal, kernel, threshold=DEFAULT_THRESHOLD):
    """Dense cross-correlation with the reference's snap and padding:
    ``signal`` a float32 (H, W) tensor, ``kernel`` an (mk, nk) array or a
    ``(left, right)`` factorisation (the ``--tsvd`` path).  Returns a
    float32 tensor shaped like ``signal``, zero where the kernel overlaps
    an edge (``chromosight_tpu/ops/convolve.py:522-542``)."""
    if isinstance(kernel, tuple):
        left = torch.as_tensor(kernel[0]).to(torch.float32)
        right = torch.as_tensor(kernel[1]).to(torch.float32)
        if left.shape[1] != right.shape[0]:
            raise ValueError("Kernel factorisation is invalid")
        kshape = (left.shape[0], right.shape[1])
        out = conv2d_valid_separable(signal.float(), left, right)
    else:
        kernel = torch.as_tensor(kernel).to(torch.float32)
        kshape = tuple(kernel.shape)
        out = conv2d_valid(signal.float(), kernel)
    return pad_margins(snap_small(out.float(), threshold), kshape)
