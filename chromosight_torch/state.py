"""Carry the JAX package's state into the port.

Both take duck-typed ``chromosight_tpu`` objects and import no jax, so a
test can run the two packages on the same state: a JAX ``ContactMap``
after ``create_mat`` (band, dense or CSR) becomes a port ``ContactMap``
ready to detect.
"""

from __future__ import annotations

import numpy as np
import torch

from chromosight_torch.runtime.contact_map import ContactMap


def kernel_config_from_jax(cfg):
    """A port kernel config from a ``chromosight_tpu`` one: float64 numpy
    kernels and plain Python scalars."""
    out = {}
    for key, value in cfg.items():
        if key == "kernels":
            out[key] = [np.asarray(k, dtype=np.float64) for k in value]
        elif isinstance(value, np.generic):
            out[key] = value.item()
        else:
            out[key] = value
    return out


def contact_map_from_jax(cm, device):
    """A port ``ContactMap`` on ``device`` holding the preprocessed map of
    a ``chromosight_tpu`` ``ContactMap`` after ``create_mat``, in the
    port's layout: a band cut from its shape bucket to (rows,
    keep_distance + 1) (what the cut drops is zero bucket padding); a
    dense map as a float64 tensor; a CSR map as a copy on the host.  The
    trans, raw-count and isotonic-law switches come along; the dump
    directory does not."""
    port = ContactMap(
        None,
        [tuple(e) for e in cm.extent],
        device=torch.device(device),
        name=cm.name,
        detectable_bins=cm.detectable_bins,
        max_dist=cm.max_dist,
        largest_kernel=cm.largest_kernel,
        use_norm=cm.use_norm,
        smooth=cm.smooth,
        inter=bool(cm.inter),
    )
    if cm.band_dev is not None:
        band = np.asarray(cm.band_dev, dtype=np.float32)
        band = band[: port.shape[0], : port.keep_distance + 1].copy()
        port.band_dev = torch.from_numpy(band).to(port.device)
    elif cm.sparse is not None:
        port.sparse = cm.sparse.copy()
    else:
        port.dense_dev = torch.from_numpy(np.asarray(cm.dense, dtype=np.float64)).to(port.device)
    return port
