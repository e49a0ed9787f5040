"""One chromosome pair's contact map, preprocessed on the device.

Counterpart of ``chromosight_tpu/runtime/contact_map.py``.  A map takes
one of three forms:

* ``band_dev``: an intra map with a bounded scan distance, its upper band
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
* ``dense_dev``: an inter map, or an intra map without a bounded scan
  distance, of at most ``DENSE_LIMIT`` bins per side: the whole
  rectangle in float64 on the device (the dense engine).
* ``sparse``: an inter map larger than that, kept as a float32 scipy CSR
  matrix on the host; the tiled engine scans it on the device
  (``ops.tiled``) and never densifies it.

Inter maps are divided by the median of their stored pixels.  The JAX
package's host views ``band``, ``dense`` and ``matrix`` download the map.

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
from chromosight_torch.runtime.dump import (  # noqa: F401 (DumpMatrix: the JAX module's name)
    DumpMatrix,
    announce,
    save_band_snapshot,
    save_matrix_snapshot,
    save_snapshot,
)

# Intra maps with a bounded scan distance and more bins than this take the
# band engine: every one, as in the JAX package by default (its
# CHROMOSIGHT_TPU_BAND_THRESHOLD raises it to force the dense engine).
BAND_THRESHOLD = 0

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

    The JAX package's signature, then the port's keywords.  ``extent`` is
    [(s1, e1), (s2, e2)] in genome bins; ``detectable_bins`` the (rows,
    cols) local indices of bins with finite weights; ``inter`` True for a
    trans pair; ``max_dist`` the scan distance in bins (None: the whole
    map); ``largest_kernel`` the widest kernel side; ``dump`` the
    ``--dump`` directory or None; ``smooth`` for ``--smooth-trend``;
    ``sample`` the ``--subsample`` share and ``rng`` the ``RandomState``
    it draws from; ``use_norm`` False for ``--norm raw``; ``devices`` the
    run's devices, over which the tiled engine spreads a sparse map's
    batches (default: ``device`` alone).

    After ``create_mat`` one of ``band_dev`` (a band map's float32 (n, W)
    tensor on the device), ``dense_dev`` (a dense map's float64 tensor on
    the device) or ``sparse`` (a large trans map's host CSR matrix) holds
    the preprocessed map (module docstring); all are None before it and
    after ``destroy_mat``.  The JAX package's host views read them:
    ``band`` (float64 ndarray (n, W)), ``dense`` (float64 ndarray, a band
    map expanded to its upper triangle) and ``matrix`` (scipy CSR)."""

    def __init__(
        self,
        clr,
        extent,
        name="",
        detectable_bins=None,
        inter=False,
        max_dist=None,
        largest_kernel=0,
        dump=None,
        smooth=False,
        sample=None,
        use_norm=True,
        *,
        device=None,
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
        self.band_dev = None
        self.dense_dev = None
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

    # -- the map and its views ---------------------------------------- #
    @property
    def band(self):
        """A band map as a float64 ndarray (n, W) on the host, or None
        (``chromosight_tpu/runtime/contact_map.py:158-168``)."""
        if self.band_dev is None:
            return None
        return download(self.band_dev[: self.shape[0]]).astype(np.float64)

    @property
    def dense(self):
        """The map as a float64 ndarray on the host: a dense map, or a
        band map expanded to its upper triangle; None for a sparse map and
        before ``create_mat`` (``chromosight_tpu/runtime/
        contact_map.py:144-152``)."""
        if self.dense_dev is not None:
            return download(self.dense_dev).astype(np.float64)
        if self.band_dev is None:
            return None
        band = self.band
        n = band.shape[0]
        out = np.zeros((n, n))
        i, d = np.nonzero(band)
        ok = i + d < n
        out[i[ok], i[ok] + d[ok]] = band[i[ok], d[ok]]
        return out

    @property
    def matrix(self):
        """The map as a scipy CSR matrix on the host (a band map as its
        upper triangle), or None before ``create_mat``: the JAX package's
        ``matrix`` view.  Set it to a dense or sparse matrix to make the
        map a dense one on the device."""
        import scipy.sparse as sp

        if self.sparse is not None:
            return self.sparse
        if self.dense_dev is not None:
            return sp.csr_matrix(download(self.dense_dev))
        if self.band_dev is None:
            return None
        band = self.band
        n = band.shape[0]
        i, d = np.nonzero(band)
        ok = i + d < n
        i, d = i[ok], d[ok]
        return sp.coo_matrix((band[i, d], (i, i + d)), shape=(n, n)).tocsr()

    @matrix.setter
    def matrix(self, value):
        import scipy.sparse as sp

        self.band_dev = self.sparse = self._structure = None
        if value is None:
            self.dense_dev = None
            return
        value = value.toarray() if sp.issparse(value) else value
        self.dense_dev = upload(np.asarray(value, dtype=np.float64), self.device)

    # -- fetch --------------------------------------------------------- #
    def _draw(self, sub, balance):
        """COO triplets (rows, cols, values) of a draw of ``sub`` of the
        map's raw contacts (a share up to 1), balanced with the stored
        weights when ``balance`` (``chromosight_tpu/runtime/
        contact_map.py:479-504``)."""
        import scipy.sparse as sp

        (s1, e1), (s2, e2) = self.extent
        rows, cols, vals = self.clr.pixels_coo((s1, e1), (s2, e2), balance=False)
        subsample = float(sub)
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
        if balance:
            w = self.clr.weights
            vals = vals * w[rows + s1] * w[cols + s2]
        return rows, cols, vals

    def _subsampled_band(self, width, sub, balance):
        """The upper band (n, width) float32 of a ``_draw(sub, balance)``,
        and its ``01_subsampled`` snapshot: the draw's upper triangle on
        the diagonals the JAX package's band holds (``_jax_band_width``)."""
        n = self.shape[0]
        rows, cols, vals = self._draw(sub, balance)
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

    def subsample(self, sub, balance=True):
        """Replace the map by a draw of ``sub`` of its raw contacts (a
        share up to 1), balanced with the stored weights when ``balance``,
        not preprocessed: a band map's float32 band on the device, else
        the dense or sparse map (``chromosight_tpu/runtime/
        contact_map.py:479-504``); snapshot ``01_subsampled`` with
        ``--dump``.  Each call draws anew from ``rng``."""
        if self.is_banded:
            self._fetch_band((sub, balance))
            self.dense_dev = self.sparse = self._structure = None
            return
        self._materialize(*self._draw(sub, balance))
        self._dump("01_subsampled", "subsample")

    def create_mat(self):
        """Fetch the map (a fresh ``subsample`` draw with ``sample``),
        upload it and preprocess it: ``preprocess_intra_matrix``, or a
        trans map's ``preprocess_inter_matrix`` and its NaN (balanced) or
        missing-bin (raw) zeroing."""
        (s1, e1), (s2, e2) = self.extent
        if self.is_banded and self.sample is None:
            self._fetch_band()
        elif self.is_banded:
            self.subsample(self.sample, balance=self.use_norm)
        else:
            with stage("io: trans fetch" if self.inter else "io: fetch", self.device):
                if self.sample is not None:
                    self.subsample(self.sample, balance=self.use_norm)
                else:
                    fetch = self.clr.trans_coo_raw if self.inter else self.clr.pixels_coo
                    self._materialize(*fetch((s1, e1), (s2, e2), balance=self.use_norm))
        with stage("preprocess", self.device):
            if self.inter:
                self.preprocess_inter_matrix()
                self._zero_missing()
            else:
                self.preprocess_intra_matrix()

    def _fetch_band(self, draw=None):
        """Fetch a band map and upload it: its raw counts packed
        (``band_upper_counts_auto``) and finalized on the device
        (``_finalize_counts``), or the float32 band, that of a
        ``_subsampled_band(width, *draw)`` with ``draw`` = (sub, balance);
        recorded in ``observability.band_uploads()``."""
        (s1, e1), _ = self.extent
        width = self.keep_distance + 1
        pack = band_host = None
        with stage("io: fetch+scatter", self.device):
            if draw is not None:
                band_host = self._subsampled_band(width, *draw)
            elif COUNT_PACKING is not None and (not self.use_norm or self.clr.weights is not None):
                pack = self.clr.band_upper_counts_auto(
                    (s1, e1),
                    width,
                    allow_u8=COUNT_PACKING in ("u4", "u8"),
                    allow_u4=COUNT_PACKING == "u4",
                    u4_head=U4_HEAD,
                )
            if pack is None and band_host is None:
                band_host = self.clr.band_upper((s1, e1), width, balance=self.use_norm)
        with stage("io: upload", self.device):
            if pack is None:
                self.band_dev = band_finalize_upload(upload(band_host, self.device), width)
            else:
                self.band_dev = self._finalize_counts(pack, width)
        mode = "f32" if pack is None else pack[0]
        exceptions = len(pack[-1]) if mode in ("u4", "u8") else 0
        observability.record_band_upload(self.name, mode, exceptions, (e1 - s1, width))

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

    def _materialize(self, rows, cols, vals):
        """Fetched COO triplets as a float64 dense map on the device (with
        the mask of stored pixels), or above ``DENSE_LIMIT`` bins a side as
        a sparse CSR matrix on the host (inter maps only; the JAX package
        has no engine for such intra maps either)."""
        n1, n2 = self.shape
        self.band_dev = self.dense_dev = self.sparse = self._structure = None
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
        self.dense_dev = torch.zeros((n1, n2), dtype=torch.float64, device=self.device)
        self.dense_dev.index_put_(at, values)
        self._structure = torch.zeros((n1, n2), dtype=torch.bool, device=self.device)
        self._structure.index_put_(at, torch.ones_like(values, dtype=torch.bool))

    # -- preprocessing ------------------------------------------------- #
    def _detectable_rows(self):
        """The (n,) bool mask of detectable rows on the device."""
        detect = np.zeros(self.shape[0], dtype=bool)
        detect[np.asarray(self.detectable_bins[0], dtype=np.int64)] = True
        return torch.from_numpy(detect).to(self.device)

    def preprocess_intra_matrix(self):
        """Preprocess a fetched intra map as ``create_mat`` does
        (``chromosight_tpu/runtime/contact_map.py:527-562``, with the NaN
        or missing-bin zeroing its ``create_mat`` does after it): a band
        map through the fused ``band_preprocess``, or with
        ``--smooth-trend`` or ``--dump`` through ``detrend`` and
        ``remove_diags``; a dense map through ``detrend`` and
        ``remove_diags``."""
        n = self.shape[0]
        if self.band_dev is None:
            self.detrend()
            self.remove_diags()
        elif self.smooth or self.dump is not None:
            self.detrend()
            self.remove_diags()
            if self.use_norm:
                self.band_dev = torch.where(torch.isnan(self.band_dev), 0.0, self.band_dev)
        else:
            pre_args = (
                self.band_dev,
                self._detectable_rows(),
                self._max_val,
                self.keep_distance,
                min(self.keep_distance + 1, n),
            )
            observability.account_dispatch(
                "band_preprocess", preprocess_cost, *pre_args, zero_nan=self.use_norm
            )
            self.band_dev = band_preprocess(*pre_args, zero_nan=self.use_norm)
        self._zero_missing()

    def _zero_missing(self):
        """Zero NaN pixels (balanced maps; a band map's preprocess has
        zeroed them) or the pixels of missing bins (``--norm raw``)."""
        n1, n2 = self.shape
        if self.band_dev is not None:
            if not self.use_norm:
                missing = missing_flags(self.detectable_bins[1], n1)
                self.band_dev = band_zero_missing(
                    self.band_dev, torch.from_numpy(missing).to(self.device)
                )
        elif self.sparse is not None:
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
            self.dense_dev = torch.where(torch.isnan(self.dense_dev), 0.0, self.dense_dev)
        else:
            for axis in (0, 1):
                missing = valid_to_missing(self.detectable_bins[axis], self.shape[axis])
                self.dense_dev.index_fill_(axis, torch.from_numpy(missing).to(self.device), 0.0)

    def detrend(self):
        """Detrend the map by its distance law, in place
        (``chromosight_tpu/runtime/contact_map.py:564-618``): a band map
        through ``detrend_band``, a dense one through ``detrend_dense``.
        Snapshot ``01_detrended`` with ``--dump``."""
        if self.band_dev is not None:
            self.detrend_band(self.band_dev, self._detectable_rows())
        else:
            self.detrend_dense()

    def detrend_band(self, band, detect):
        """Detrend ``band`` by its distance law over the ``detect`` rows
        into the map's band, with the isotonic (non-increasing) fit when
        ``smooth``; the law is reduced on the device and fitted on the
        host.  Snapshot ``01_detrended`` with ``--dump``."""
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
        self.band_dev = band_detrend_trim(
            band,
            torch.from_numpy(law.astype(np.float32)),
            self._max_val,
            band.shape[1],
        )
        if self.dump is not None:
            save_band_snapshot(self.dump, self.name, "01_detrended", self.band_dev, n, "detrend")

    def detrend_dense(self):
        """Detrend a dense intra map by its distance law in float32, as
        the JAX package does on its device (``chromosight_tpu/runtime/
        contact_map.py:602-618``); snapshot ``01_detrended``."""
        n = self.shape[0]
        mat = self.dense_dev.float()
        law = distance_law_dense(
            mat, self._detectable_rows(), n_diags=min(self.keep_distance + 1, n),
            smooth=self.smooth,
        )
        law[np.isnan(law)] = 0.0
        self.dense_dev = detrend_dense(
            mat, torch.from_numpy(law.astype(np.float32)), self._max_val
        ).double()
        self._structure = None
        self._dump("01_detrended", "detrend")

    def remove_diags(self):
        """Zero the diagonals beyond ``keep_distance`` (and, on a dense
        map, below the main one).  Snapshot ``02_remove_diags`` with
        ``--dump``."""
        if self.dense_dev is not None:
            self.dense_dev = diag_trim_dense(self.dense_dev.float(), self.keep_distance).double()
            self._dump("02_remove_diags", "remove_diags")
            return
        d = torch.arange(self.band_dev.shape[1], device=self.band_dev.device)
        self.band_dev = torch.where((d <= self.keep_distance)[None, :], self.band_dev, 0.0)
        if self.dump is not None:
            save_band_snapshot(
                self.dump, self.name, "02_remove_diags", self.band_dev, self.shape[0],
                "remove_diags",
            )

    def _dump(self, stage_name, after):
        """The ``--dump`` snapshot of the dense or sparse map."""
        if self.dump is None:
            return
        mat = self.sparse if self.sparse is not None else download(self.dense_dev)
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
            self.dense_dev = inter_median_scale(self.dense_dev, self._structure)
        self._structure = None
        self._dump("01_process_inter", "preprocess_inter_matrix")

    def destroy_mat(self):
        """Free the map."""
        self.band_dev = None
        self.dense_dev = None
        self.sparse = None
        self._structure = None
