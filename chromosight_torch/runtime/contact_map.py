"""One chromosome's contact map, held as its upper band on the device.

Counterpart of ``chromosight_tpu/runtime/contact_map.py``, band branch
only: every intra map with a bounded scan distance goes to the band
engine there (``BAND_THRESHOLD = 0``).  ``create_mat`` scatters the
balanced f32 band on the host, uploads it and preprocesses it on the
device (distance law, detrend, trim, NaN zeroing).  Rows are not padded to
shape buckets: the kernels take any row count.
"""

from __future__ import annotations

import numpy as np
import torch

from chromosight_torch import NotPortedError
from chromosight_torch.device import stage
from chromosight_torch.ops.band import band_finalize_upload, band_preprocess


class ContactMap:
    """An intra-chromosomal map on ``device``.

    ``extent`` is [(s, e), (s, e)] in genome bins; ``detectable_bins`` the
    (rows, cols) local indices of bins with finite weights; ``max_dist``
    the scan distance in bins; ``largest_kernel`` the widest kernel side.
    ``band`` is the preprocessed (rows, keep_distance + 1) f32 band, or
    None before ``create_mat`` and after ``destroy_mat``."""

    def __init__(
        self,
        clr,
        extent,
        device,
        name="",
        detectable_bins=None,
        max_dist=None,
        largest_kernel=0,
    ):
        self.clr = clr
        self.extent = extent
        self.device = device
        self.name = name
        self.detectable_bins = detectable_bins
        self.max_dist = max_dist
        self.largest_kernel = largest_kernel
        self.band = None

    @property
    def is_banded(self):
        return self.max_dist is not None

    @property
    def shape(self):
        (s1, e1), (s2, e2) = self.extent
        return (e1 - s1, e2 - s2)

    @property
    def keep_distance(self):
        """Scanning distance plus kernel margin (contacts_map.py:629-638)."""
        n = self.shape[0]
        mat_max_dist = n if self.max_dist is None else min(self.max_dist, n)
        return mat_max_dist + self.largest_kernel

    def create_mat(self):
        """Fetch the balanced band, upload it and preprocess it."""
        if not self.is_banded:
            raise NotPortedError(
                "maps without a bounded max_dist (dense engine)", 8
            )
        (s1, e1), _ = self.extent
        n = e1 - s1
        width = self.keep_distance + 1
        with stage("io: fetch+scatter", self.device):
            band_host = self.clr.band_upper((s1, e1), width, balance=True)
        with stage("io: upload", self.device):
            band = band_finalize_upload(
                torch.from_numpy(band_host).to(self.device), width
            )
        with stage("preprocess", self.device):
            detect = np.zeros(n, dtype=bool)
            detect[np.asarray(self.detectable_bins[0], dtype=np.int64)] = True
            self.band = band_preprocess(
                band,
                torch.from_numpy(detect).to(self.device),
                10,
                self.keep_distance,
                min(self.keep_distance + 1, n),
                zero_nan=True,
            )

    def destroy_mat(self):
        """Free the band."""
        self.band = None
