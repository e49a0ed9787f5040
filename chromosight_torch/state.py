"""Carry the JAX package's state into the port.

Both take duck-typed ``chromosight_tpu`` objects and import no jax, so a
test can run the two packages on the same state: a JAX ``ContactMap``
after ``create_mat`` becomes a port ``ContactMap`` ready to detect.
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
    """A port ``ContactMap`` on ``device`` holding the preprocessed band of
    a ``chromosight_tpu`` ``ContactMap`` after ``create_mat``, cut from
    its shape bucket to the port's own layout: (rows, keep_distance + 1).
    What the cut drops is zero (bucket padding).  The raw-count and
    isotonic-law switches come along; the dump directory does not."""
    port = ContactMap(
        None,
        [tuple(e) for e in cm.extent],
        torch.device(device),
        name=cm.name,
        detectable_bins=cm.detectable_bins,
        max_dist=cm.max_dist,
        largest_kernel=cm.largest_kernel,
        use_norm=cm.use_norm,
        smooth=cm.smooth,
    )
    band = np.asarray(cm.band_dev, dtype=np.float32)
    band = band[: port.shape[0], : port.keep_distance + 1].copy()
    port.band = torch.from_numpy(band).to(port.device)
    return port
