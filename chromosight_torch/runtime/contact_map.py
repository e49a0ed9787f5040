"""One chromosome pair's contact map, preprocessed on the device.

Counterpart of ``chromosight_tpu/runtime/contact_map.py``.  A map takes
one of three forms:

* ``band``: an intra map with a bounded scan distance, its upper band
  (rows, keep_distance + 1) in float32 on the device (the band engine;
  every such map goes there, ``BAND_THRESHOLD = 0`` in the JAX package).
  ``create_mat`` scatters the band on the host, uploads it and
  preprocesses it on the device: distance law, detrend, trim, then NaN
  zeroing (balanced) or zeroing of the missing bins (raw).  A map ships
  its raw counts packed into u4, u8 or u16 (``band_upper_counts_auto``)
  with its float64 weights, and the device unpacks and balances them
  (``ops.band.band_unpack``, ``band_weighted``) into the band the host
  path gives; a map whose counts do not pack, and a ``--subsample`` draw,
  ship the balanced (or, with ``--norm raw``, the raw) float32 band.
  ``observability.band_uploads()`` records the form each band map took.
  The fused ``band_preprocess`` is the default; ``--smooth-trend``
  (isotonic distance law) and ``--dump`` take the staged ``detrend`` then
  ``remove_diags``, as the JAX package does.
* ``dense``: an inter map, or an intra map without a bounded scan
  distance, of at most ``DENSE_LIMIT`` bins per side: the whole
  rectangle in float64 on the device (the dense engine).
* ``sparse``: an inter map larger than that, kept as a float32 scipy CSR
  matrix on the host; the tiled engine scans it on the device
  (``ops.tiled``) and never densifies it.

Inter maps are divided by the median of their stored pixels.

With ``sample`` (``--subsample``) ``create_mat`` first draws that share
of the map's raw contacts (mirrored triangle included, as the JAX
package's ``pixels_coo`` gives them) from the genome's ``RandomState``,
then balances the draw with the stored weights
(``chromosight_tpu/runtime/contact_map.py:479-504``); every call draws
anew.
"""

from __future__ import annotations

import numpy as np
import torch

from chromosight_torch import native, observability
from chromosight_torch.device import download, resolve_device, stage, upload
from chromosight_torch.ops.band import (
    band_detrend_trim,
    band_diag_stats,
    band_finalize_upload,
    band_preprocess,
    band_unpack,
    band_weighted,
    band_zero_missing,
    preprocess_cost,
)
from chromosight_torch.ops.preprocess import (
    diag_trim_dense,
    detrend_dense,
    distance_law_dense,
    inter_median_scale,
)
from chromosight_torch.preprocessing import (
    missing_flags,
    pava_decreasing,
    subsample_contacts,
    valid_to_missing,
)
from chromosight_torch.runtime.dump import (
    announce,
    save_band_snapshot,
    save_matrix_snapshot,
    save_snapshot,
)

# Maps larger than this many bins on a side are not densified: inter maps
# stay sparse and go to the tiled engine.  Tests lower it to force that
# path on small maps.
DENSE_LIMIT = 8192

# The narrowest form a band map's raw counts ship in: "u4" (a uint8 head
# of U4_HEAD diagonals, the other diagonals two per byte), "u8" or "u16",
# each with the counts that do not fit as exceptions; a map whose counts
# do not fit falls back to the next wider form, then to the float32 band.
# None ships the float32 band (tests and chip_smoke.py set it to compare
# the forms; every form gives the same band).
COUNT_PACKING = "u4"
U4_HEAD = 64


def _jax_band_width(width):
    """The width of the JAX package's band tensor for a ``width``-wide
    band: rounded up to a power of two of at least 128 columns, then to
    a multiple of 8192 (``chromosight_tpu/runtime/contact_map.py:35-42``).
    Its ``01_subsampled`` snapshot holds that many diagonals."""
    width = max(int(width), 128)
    if width <= 8192:
        return 1 << (width - 1).bit_length()
    return -(-width // 8192) * 8192


class ContactMap:
    """A contact map on ``device`` (None: the first CUDA card, and a raise
    without one; the CPU only when asked for).

    ``extent`` is [(s1, e1), (s2, e2)] in genome bins; ``detectable_bins``
    the (rows, cols) local indices of bins with finite weights; ``inter``
    True for a trans pair; ``max_dist`` the scan distance in bins (None:
    the whole map); ``largest_kernel`` the widest kernel side;
    ``use_norm`` False for ``--norm raw``; ``smooth`` for
    ``--smooth-trend``; ``dump`` the ``--dump`` directory or None;
    ``sample`` the ``--subsample`` share and ``rng`` the ``RandomState``
    it draws from; ``devices`` the run's devices, over which the tiled
    engine spreads a sparse map's batches (default: ``device`` alone).
    After ``create_mat`` one of ``band``, ``dense`` or ``sparse`` holds
    the preprocessed map (module docstring); all are None before it and
    after ``destroy_mat``."""

    def __init__(
        self,
        clr,
        extent,
        device=None,
        name="",
        detectable_bins=None,
        max_dist=None,
        largest_kernel=0,
        use_norm=True,
        smooth=False,
        dump=None,
        inter=False,
        sample=None,
        rng=None,
        devices=None,
    ):
        self.clr = clr
        self.extent = extent
        self.device = resolve_device(device)
        self.devices = (self.device,) if devices is None else tuple(devices)
        self.sample = sample
        self.rng = rng
        self.name = name
        self.detectable_bins = detectable_bins
        self.max_dist = max_dist
        self.largest_kernel = largest_kernel
        self.use_norm = use_norm
        self.smooth = smooth
        self.dump = dump
        self.inter = inter
        self.band = None
        self.dense = None
        self.sparse = None
        self._structure = None

    @property
    def is_banded(self):
        return not self.inter and self.max_dist is not None

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

    @property
    def matrix(self):
        """The preprocessed map as a scipy CSR matrix on the host (a band
        map as its upper triangle), or None before ``create_mat``: the JAX
        package's ``matrix`` view."""
        import scipy.sparse as sp

        if self.sparse is not None:
            return self.sparse
        if self.dense is not None:
            return sp.csr_matrix(download(self.dense))
        if self.band is None:
            return None
        n = self.shape[0]
        band = download(self.band[:n]).astype(np.float64)
        i, d = np.nonzero(band)
        ok = i + d < n
        i, d = i[ok], d[ok]
        return sp.coo_matrix((band[i, d], (i, i + d)), shape=(n, n)).tocsr()

    def subsample(self):
        """COO triplets (rows, cols, values) of a draw of ``sample`` of the
        map's raw contacts, balanced with the stored weights unless
        ``--norm raw`` (``chromosight_tpu/runtime/contact_map.py:
        479-504``)."""
        import scipy.sparse as sp

        (s1, e1), (s2, e2) = self.extent
        rows, cols, vals = self.clr.pixels_coo((s1, e1), (s2, e2), balance=False)
        subsample = float(self.sample)
        if subsample < 0:
            raise ValueError("Subsample must be strictly positive.")
        elif subsample <= 1:
            subsample *= vals.sum()
        else:
            raise ValueError("Subsample cannot be above 1")
        subsample = int(subsample)
        if subsample < vals.sum():
            coo = sp.coo_matrix((vals, (rows, cols)), shape=self.shape)
            coo = subsample_contacts(coo, subsample, self.rng)
            rows, cols, vals = coo.row, coo.col, coo.data
        if self.use_norm:
            w = self.clr.weights
            vals = vals * w[rows + s1] * w[cols + s2]
        return rows, cols, vals

    def _subsampled_band(self, width):
        """The upper band (n, width) float32 of a ``subsample`` draw, and
        its ``01_subsampled`` snapshot: the draw's upper triangle on the
        diagonals the JAX package's band holds (``_jax_band_width``)."""
        n = self.shape[0]
        rows, cols, vals = self.subsample()
        rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
        d = cols - rows
        band = native.coo_to_band(rows, cols, vals, n, width, dtype=np.float32)
        if band is None:
            keep = (d >= 0) & (d < width)
            band = np.zeros((n, width), dtype=np.float32)
            band[rows[keep], d[keep]] = vals[keep]
        if self.dump is not None:
            keep = (d >= 0) & (d < _jax_band_width(width))
            v = vals[keep].astype(np.float32)
            nz = v != 0
            stage_name = "01_subsampled"
            announce(f"Dumping matrix to {self.dump / f'{self.name}_{stage_name}'} "
                     "after executing subsample")
            save_snapshot(self.dump, self.name, stage_name, rows[keep][nz],
                          cols[keep][nz], v[nz], n)
        return band

    def create_mat(self):
        """Fetch the map (a fresh ``subsample`` draw with ``sample``),
        upload it and preprocess it."""
        if not self.is_banded:
            self._create_unbanded()
            return
        (s1, e1), _ = self.extent
        n = e1 - s1
        width = self.keep_distance + 1
        pack = None
        with stage("io: fetch+scatter", self.device):
            if (
                self.sample is None
                and COUNT_PACKING is not None
                and (not self.use_norm or self.clr.weights is not None)
            ):
                pack = self.clr.band_upper_counts_auto(
                    (s1, e1),
                    width,
                    allow_u8=COUNT_PACKING in ("u4", "u8"),
                    allow_u4=COUNT_PACKING == "u4",
                    u4_head=U4_HEAD,
                )
            if pack is None and self.sample is None:
                band_host = self.clr.band_upper((s1, e1), width, balance=self.use_norm)
            elif pack is None:
                band_host = self._subsampled_band(width)
        with stage("io: upload", self.device):
            if pack is None:
                band = band_finalize_upload(upload(band_host, self.device), width)
            else:
                band = self._finalize_counts(pack, width)
        mode = "f32" if pack is None else pack[0]
        exceptions = len(pack[-1]) if mode in ("u4", "u8") else 0
        observability.record_band_upload(self.name, mode, exceptions, (n, width))
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
                pre_args = (
                    band,
                    detect,
                    self._max_val,
                    self.keep_distance,
                    min(self.keep_distance + 1, n),
                )
                observability.account_dispatch(
                    "band_preprocess", preprocess_cost, *pre_args, zero_nan=self.use_norm
                )
                self.band = band_preprocess(*pre_args, zero_nan=self.use_norm)
            if not self.use_norm:
                missing = missing_flags(self.detectable_bins[1], n)
                self.band = band_zero_missing(
                    self.band, torch.from_numpy(missing).to(self.device)
                )

    def _finalize_counts(self, pack, width):
        """The float32 (n, width) band on the device from a
        ``band_upper_counts_auto`` pack: its arrays (the exceptions as
        int32 flat indices and float32 values) and, unless ``--norm raw``,
        the rows' float64 weights are uploaded, then unpacked and balanced
        on the device (``chromosight_tpu/runtime/contact_map.py:265-324``,
        without the power-of-two padding of the exceptions)."""
        mode, *arrays = pack
        if mode != "u16":
            arrays[-2] = arrays[-2].astype(np.int32)  # n * width < 2^31
        band = band_unpack(mode, [upload(a, self.device) for a in arrays], width)
        if not self.use_norm:
            return band
        (s1, e1), _ = self.extent
        return band_weighted(band, upload(self.clr.weights[s1:e1], self.device))

    def detrend(self, band, detect):
        """Detrend by the distance law, with its isotonic (non-increasing)
        fit when ``smooth``; the law is reduced on the device and fitted on
        the host (``chromosight_tpu/runtime/contact_map.py:564-618``).
        Snapshot ``01_detrended`` with ``--dump``."""
        n = self.shape[0]
        n_diags = min(self.keep_distance + 1, n)
        sums, counts = band_diag_stats(band, detect)
        # the law is fitted on the host: a download the JAX package's fused
        # path does not have, counted all the same
        sums = download(sums).astype(np.float64)[:n_diags]
        counts = download(counts).astype(np.float64)[:n_diags]
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
        """Zero the diagonals beyond ``keep_distance`` (and, on a dense
        map, below the main one).  Snapshot ``02_remove_diags`` with
        ``--dump``."""
        if self.dense is not None:
            self.dense = diag_trim_dense(self.dense.float(), self.keep_distance).double()
            self._dump("02_remove_diags", "remove_diags")
            return
        d = torch.arange(self.band.shape[1], device=self.band.device)
        self.band = torch.where((d <= self.keep_distance)[None, :], self.band, 0.0)
        if self.dump is not None:
            save_band_snapshot(
                self.dump, self.name, "02_remove_diags", self.band, self.shape[0],
                "remove_diags",
            )

    def _create_unbanded(self):
        """Dense or sparse map: fetch the rectangle's pixels, keep them
        (``_materialize``), preprocess them (median scale, or detrend and
        trim for intra maps), then zero NaN pixels (balanced) or missing
        bins (raw) (``chromosight_tpu/runtime/contact_map.py:355-412``)."""
        (s1, e1), (s2, e2) = self.extent
        n1, n2 = e1 - s1, e2 - s2
        with stage("io: trans fetch" if self.inter else "io: fetch", self.device):
            if self.sample is None:
                fetch = self.clr.trans_coo_raw if self.inter else self.clr.pixels_coo
                rows, cols, vals = fetch((s1, e1), (s2, e2), balance=self.use_norm)
            else:
                rows, cols, vals = self.subsample()
            self._materialize(rows, cols, vals)
            if self.sample is not None:
                self._dump("01_subsampled", "subsample")
        with stage("preprocess", self.device):
            if self.inter:
                self.preprocess_inter_matrix()
            else:
                self.detrend_dense()
                self.remove_diags()
            if self.sparse is not None:
                coo = self.sparse.tocoo()
                if self.use_norm:
                    coo.data[np.isnan(coo.data)] = 0
                else:
                    mr = missing_flags(self.detectable_bins[0], n1)
                    mc = missing_flags(self.detectable_bins[1], n2)
                    coo.data[mr[coo.row] | mc[coo.col]] = 0
                coo.eliminate_zeros()
                self.sparse = coo.tocsr()
            elif self.use_norm:
                self.dense = torch.where(torch.isnan(self.dense), 0.0, self.dense)
            else:
                for axis in (0, 1):
                    missing = valid_to_missing(self.detectable_bins[axis], self.shape[axis])
                    self.dense.index_fill_(axis, torch.from_numpy(missing).to(self.device), 0.0)

    def _materialize(self, rows, cols, vals):
        """Fetched COO triplets as a float64 dense map on the device (with
        the mask of stored pixels), or above ``DENSE_LIMIT`` bins a side as
        a sparse CSR matrix on the host (inter maps only; the JAX package
        has no engine for such intra maps either)."""
        n1, n2 = self.shape
        if max(n1, n2) > DENSE_LIMIT:
            if not self.inter:
                raise ValueError(
                    f"{self.name}: intra maps above DENSE_LIMIT={DENSE_LIMIT} bins "
                    "need a bounded max_dist (the band engine)"
                )
            import scipy.sparse as sp

            self.sparse = sp.coo_matrix((vals, (rows, cols)), shape=(n1, n2)).tocsr()
            return
        at = tuple(upload(np.asarray(a, np.int64), self.device) for a in (rows, cols))
        values = upload(np.asarray(vals, np.float64), self.device)
        self.dense = torch.zeros((n1, n2), dtype=torch.float64, device=self.device)
        self.dense.index_put_(at, values)
        self._structure = torch.zeros((n1, n2), dtype=torch.bool, device=self.device)
        self._structure.index_put_(at, torch.ones_like(values, dtype=torch.bool))

    def _dump(self, stage_name, after):
        """The ``--dump`` snapshot of the dense or sparse map."""
        if self.dump is None:
            return
        mat = self.sparse if self.sparse is not None else download(self.dense)
        save_matrix_snapshot(self.dump, self.name, stage_name, mat, after)

    def preprocess_inter_matrix(self):
        """Divide an inter map by the median of its stored pixels, NaN
        pixels zeroed first (``chromosight_tpu/runtime/contact_map.py:
        506-525``); snapshot ``01_process_inter`` with ``--dump``."""
        if self.sparse is not None:
            data = self.sparse.data
            data[np.isnan(data)] = 0.0
            # in the stored float32, as the JAX package divides
            data /= data.dtype.type(np.nanmedian(data))
        else:
            self.dense = inter_median_scale(self.dense, self._structure)
        self._structure = None
        self._dump("01_process_inter", "preprocess_inter_matrix")

    def detrend_dense(self):
        """Detrend a dense intra map by its distance law in float32, as
        the JAX package does on its device (``chromosight_tpu/runtime/
        contact_map.py:602-618``); snapshot ``01_detrended``."""
        n = self.shape[0]
        detect = np.zeros(n, dtype=bool)
        detect[np.asarray(self.detectable_bins[0], dtype=np.int64)] = True
        detect = torch.from_numpy(detect).to(self.device)
        mat = self.dense.float()
        law = distance_law_dense(
            mat, detect, n_diags=min(self.keep_distance + 1, n), smooth=self.smooth
        )
        law[np.isnan(law)] = 0.0
        self.dense = detrend_dense(mat, torch.from_numpy(law.astype(np.float32)), self._max_val).double()
        self._structure = None
        self._dump("01_detrended", "detrend")

    def destroy_mat(self):
        """Free the map."""
        self.band = None
        self.dense = None
        self.sparse = None
        self._structure = None
