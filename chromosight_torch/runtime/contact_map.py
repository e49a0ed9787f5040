"""One chromosome's contact map, held as its upper band on the device.

Counterpart of ``chromosight_tpu/runtime/contact_map.py``, band branch
only: every intra map with a bounded scan distance goes to the band
engine there (``BAND_THRESHOLD = 0``).  ``create_mat`` scatters the
balanced (or, with ``--norm raw``, the raw) f32 band on the host, uploads
it and preprocesses it on the device: distance law, detrend, trim, then
NaN zeroing (balanced) or zeroing of the missing bins (raw).  The fused
``band_preprocess`` is the default; ``--smooth-trend`` (isotonic distance
law) and ``--dump`` take the staged ``detrend`` then ``remove_diags``,
as the JAX package does.  Rows are not padded to shape buckets: the
kernels take any row count.
"""

from __future__ import annotations

import numpy as np
import torch

from chromosight_torch import NotPortedError
from chromosight_torch.device import stage
from chromosight_torch.ops.band import (
    band_detrend_trim,
    band_diag_stats,
    band_finalize_upload,
    band_preprocess,
    band_zero_missing,
)
from chromosight_torch.preprocessing import missing_flags, pava_decreasing
from chromosight_torch.runtime.dump import save_band_snapshot


class ContactMap:
    """An intra-chromosomal map on ``device``.

    ``extent`` is [(s, e), (s, e)] in genome bins; ``detectable_bins`` the
    (rows, cols) local indices of bins with finite weights; ``max_dist``
    the scan distance in bins; ``largest_kernel`` the widest kernel side;
    ``use_norm`` False for ``--norm raw``; ``smooth`` for
    ``--smooth-trend``; ``dump`` the ``--dump`` directory or None.
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
        use_norm=True,
        smooth=False,
        dump=None,
    ):
        self.clr = clr
        self.extent = extent
        self.device = device
        self.name = name
        self.detectable_bins = detectable_bins
        self.max_dist = max_dist
        self.largest_kernel = largest_kernel
        self.use_norm = use_norm
        self.smooth = smooth
        self.dump = dump
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

    @property
    def _max_val(self):
        """Detrended values at or above this reset to 1 (balanced maps)."""
        return 10 if self.use_norm else None

    def create_mat(self):
        """Fetch the band, upload it and preprocess it."""
        if not self.is_banded:
            raise NotPortedError(
                "maps without a bounded max_dist (dense engine)", 8
            )
        (s1, e1), _ = self.extent
        n = e1 - s1
        width = self.keep_distance + 1
        with stage("io: fetch+scatter", self.device):
            band_host = self.clr.band_upper((s1, e1), width, balance=self.use_norm)
        with stage("io: upload", self.device):
            band = band_finalize_upload(
                torch.from_numpy(band_host).to(self.device), width
            )
        with stage("preprocess", self.device):
            detect = np.zeros(n, dtype=bool)
            detect[np.asarray(self.detectable_bins[0], dtype=np.int64)] = True
            detect = torch.from_numpy(detect).to(self.device)
            if self.smooth or self.dump is not None:
                self.detrend(band, detect)
                self.remove_diags()
                if self.use_norm:
                    self.band = torch.where(torch.isnan(self.band), 0.0, self.band)
            else:
                self.band = band_preprocess(
                    band,
                    detect,
                    self._max_val,
                    self.keep_distance,
                    min(self.keep_distance + 1, n),
                    zero_nan=self.use_norm,
                )
            if not self.use_norm:
                missing = missing_flags(self.detectable_bins[1], n)
                self.band = band_zero_missing(
                    self.band, torch.from_numpy(missing).to(self.device)
                )

    def detrend(self, band, detect):
        """Detrend by the distance law, with its isotonic (non-increasing)
        fit when ``smooth``; the law is reduced on the device and fitted on
        the host (``chromosight_tpu/runtime/contact_map.py:564-618``).
        Snapshot ``01_detrended`` with ``--dump``."""
        n = self.shape[0]
        n_diags = min(self.keep_distance + 1, n)
        sums, counts = band_diag_stats(band, detect)
        sums = sums.double().cpu().numpy()[:n_diags]
        counts = counts.double().cpu().numpy()[:n_diags]
        law = np.zeros(band.shape[1])
        with np.errstate(invalid="ignore", divide="ignore"):
            law[:n_diags] = sums / counts
        if self.smooth and n > 2:
            law[~np.isfinite(law)] = 0
            law = pava_decreasing(law)
        law[np.isnan(law)] = 0.0
        self.band = band_detrend_trim(
            band,
            torch.from_numpy(law.astype(np.float32)),
            self._max_val,
            band.shape[1],
        )
        if self.dump is not None:
            save_band_snapshot(self.dump, self.name, "01_detrended", self.band, n, "detrend")

    def remove_diags(self):
        """Zero the diagonals beyond ``keep_distance``.  Snapshot
        ``02_remove_diags`` with ``--dump``."""
        d = torch.arange(self.band.shape[1], device=self.band.device)
        self.band = torch.where((d <= self.keep_distance)[None, :], self.band, 0.0)
        if self.dump is not None:
            save_band_snapshot(
                self.dump, self.name, "02_remove_diags", self.band, self.shape[0],
                "remove_diags",
            )

    def destroy_mat(self):
        """Free the band."""
        self.band = None
