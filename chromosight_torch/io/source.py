"""Contact sources: what the band path reads from a contact map.

Counterpart of ``chromosight_tpu/io/cool.py:36-253``.  A source holds a
chromosome table, a bin table and an upper-triangle pixel table sorted by
(bin1, bin2) and indexed by ``bin1_offset`` (the cool layout).  It offers
what the detect paths and ICE balancing read: ``chromnames``, ``extent``,
``binsize``, ``weights``, ``info`` (``info["sum"]``, the contact total
``--subsample`` reads), ``bins()``, ``band_upper`` (intra band, balanced
float32), ``band_upper_counts_auto`` (intra band of raw counts packed
into u4/u8/u16 for the card to finalize), ``trans_coo_raw`` (trans
maps), ``pixels_coo`` (dense intra maps, ``--subsample``, plots) and,
for
``chromosight_torch.ops.balance.ice_balance``, ``n_bins``, ``nnz``,
``_chrom_offset``, ``pixel_chunks``, ``row_slice_raw`` and
``store_weights``.

* ``CoolSource`` reads a ``.cool`` file with the port's own HDF5 reader
  (``chromosight_torch.io.hdf5``: numpy and the standard library, no
  h5py).  ICE weights are written back into the file, as the JAX package
  does.
* ``ArraySource`` holds the tables in memory: from an ``.npz`` export
  (``to_npz``/``from_npz``) or from the synthetic genome generator of
  ``tools/make_synthetic_cool.py`` (``from_synthetic``).

Bin tables are dicts of numpy columns (chrom, start, end[, weight]).
"""

from __future__ import annotations

import numpy as np

from chromosight_torch import native, observability
from chromosight_torch.io import hdf5


def native_scatter_available():
    """Whether ``band_upper`` takes the native (g++-built) scatter rather
    than its numpy fallback."""
    return native.get_lib() is not None


class _PixelSource:
    """Accessors shared by the sources.  Subclasses set the tables and
    implement ``_pixels(lo, hi)`` -> (bin1, bin2, count) of pixel rows
    [lo, hi) in their stored dtypes, ``_pixels_b2_ct(lo, hi)`` -> (bin2,
    count) of the same rows without reading bin1 (``bin1_offset`` implies
    it), and ``_count_dtype`` (the stored count dtype)."""

    _chrom_names: list
    _chrom_offset: np.ndarray
    _bin1_offset: np.ndarray
    _bin_chrom_ids: np.ndarray
    _bin_start: np.ndarray
    _bin_end: np.ndarray
    _weight: np.ndarray | None
    binsize: int | None

    @property
    def chromnames(self):
        return list(self._chrom_names)

    @property
    def n_bins(self):
        return int(self._bin1_offset.shape[0] - 1)

    @property
    def shape(self):
        return (self.n_bins, self.n_bins)

    @property
    def nnz(self):
        return int(self._bin1_offset[-1])

    @property
    def weights(self):
        return self._weight

    def extent(self, chrom):
        """(first_bin, last_bin_exclusive) of a chromosome."""
        cid = self._chrom_names.index(chrom)
        return int(self._chrom_offset[cid]), int(self._chrom_offset[cid + 1])

    def bins(self):
        """Bin table: chrom (str), start, end (int64)[, weight]."""
        table = {
            "chrom": np.asarray(self._chrom_names)[self._bin_chrom_ids],
            "start": self._bin_start.astype(np.int64),
            "end": self._bin_end.astype(np.int64),
        }
        if self._weight is not None:
            table["weight"] = self._weight
        return table

    def band_upper(self, extent, width, balance=False, n_rows=None):
        """Upper-band tensor B[i, d] = M[s+i, s+i+d], d in [0, width), as
        float32 (n_rows, width); ``n_rows`` >= e-s adds zero rows.

        The pixel slice of rows [s, e) is filtered to the band, balanced
        and scattered in one native pass
        (``chromosight_torch.native.band_scatter_fused``), with the numpy
        fallback of ``chromosight_tpu/io/cool.py:242-253``."""
        s, e = extent
        if n_rows is None:
            n_rows = e - s
        self._check_balance(balance)
        lo, hi = int(self._bin1_offset[s]), int(self._bin1_offset[e])
        if hi <= lo:
            return np.zeros((n_rows, width), dtype=np.float32)
        b1, b2, ct = self._pixels(lo, hi)
        weights = self._weight if balance else None
        observability.count("io: pixels scattered", len(b2))
        with observability.stage("io: scatter"):
            band = native.band_scatter_fused(
                b1, b2, ct, weights, s, e, width, n_rows=n_rows
            )
            if band is not None:
                return band
            d = b2.astype(np.int64) - b1.astype(np.int64)
            keep = (d >= 0) & (d < width) & (b2 < e)
            b1, d, ct = b1[keep].astype(np.int64), d[keep], ct[keep]
            vals = ct.astype(np.float32)
            if balance:
                vals = (
                    ct.astype(np.float64) * weights[b1] * weights[b1 + d]
                ).astype(np.float32)
            band = np.zeros((n_rows, width), dtype=np.float32)
            band[b1 - s, d] = vals
            return band

    def pixels_upper(self, extent, balance=False, dtype=np.float32, max_diag=None):
        """The stored upper triangle of the intra map ``extent`` = (s, e):
        (rows, cols, values) in local coordinates, the values ``count *
        w[bin1] * w[bin2]`` in ``dtype`` when ``balance``, the pixels at a
        distance of ``max_diag`` or more dropped when given
        (``chromosight_tpu/io/cool.py:165-198``)."""
        s, e = extent
        lo, hi = int(self._bin1_offset[s]), int(self._bin1_offset[e])
        if hi <= lo:
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0, dtype=dtype)
        b1, b2, ct = self._pixels(lo, hi)
        keep = b2 < e
        if max_diag is not None:
            keep &= (b2 - b1) < max_diag
        if not keep.all():
            b1, b2, ct = b1[keep], b2[keep], ct[keep]
        vals = ct.astype(dtype)
        if balance:
            self._check_balance(balance)
            w = self._weight.astype(dtype)
            vals = vals * w[b1] * w[b2]
        return b1 - s, b2 - s, vals

    def band_upper_counts(self, extent, width, n_rows=None):
        """The raw counts' upper band (n_rows, width) as uint16, or None
        where ``band_upper_counts_auto`` finds them no u16 form
        (``chromosight_tpu/io/cool.py:255-275``)."""
        out = self.band_upper_counts_auto(extent, width, n_rows=n_rows, allow_u8=False,
                                          u4_head=0)
        return None if out is None else out[1]

    def band_upper_counts_auto(
        self, extent, width, n_rows=None, allow_u8=True, allow_u4=True, *, u4_head=64
    ):
        """Upper band of RAW counts in the narrowest exact form
        (``chromosight_tpu/io/cool.py:277-334``):

        * ``("u4", head, tail, exc_idx, exc_val)``: columns [0, d0) as
          uint8 (n_rows, d0), columns [d0, width) two per byte (even
          column in the low nibble), with d0 = ``u4_head`` (only while
          0 < d0 <= width // 2; 64 by default, as in the JAX package);
        * ``("u8", band_u8, exc_idx, exc_val)``;
        * ``("u16", band_u16)``;
        * None: no native library, a count dtype other than int32, int64,
          float32 or float64, a count that is non-integral, negative or
          above 2^24 (above 65535 in u16), or more exceptions than the
          packing saves; the caller then ships :meth:`band_upper`.

        Exceptions are the counts that do not fit their lane (head > 255,
        tail > 15), as int64 flat indices into the unpacked (n_rows,
        width) band and float32 values, in no set order.  Eligibility is
        checked before the read, ``bin2`` and ``count`` of the rows are
        read once (``bin1_offset`` implies ``bin1``), and the u4 -> u8 ->
        u16 fallbacks scatter the slices already in memory again."""
        if native.get_lib() is None:
            return None
        s, e = extent
        if n_rows is None:
            n_rows = e - s
        supported = tuple(np.dtype(t) for t in (np.int32, np.int64, np.float32, np.float64))
        if self._count_dtype not in supported:
            return None
        lo, hi = int(self._bin1_offset[s]), int(self._bin1_offset[e])
        if hi <= lo:
            return ("u16", np.zeros((n_rows, width), dtype=np.uint16))
        b2, ct = self._pixels_b2_ct(lo, hi)
        indptr = self._bin1_offset[s : e + 1]
        # the pixels are counted once, by the form that took them: u4 and
        # u8 decline where their exceptions outgrow what they save
        out = None
        with observability.stage("io: scatter"):
            if allow_u4 and allow_u8 and 0 < u4_head <= width // 2:
                out = native.band_scatter_counts_u4_indptr(
                    indptr, b2, ct, s, e, width, u4_head, n_rows=n_rows
                )
                out = None if out is None else ("u4",) + out
            if out is None and allow_u8:
                out = native.band_scatter_counts_u8_indptr(
                    indptr, b2, ct, s, e, width, n_rows=n_rows
                )
                out = None if out is None else ("u8",) + out
            if out is None:
                band = native.band_scatter_counts_indptr(indptr, b2, ct, s, e, width,
                                                         n_rows=n_rows)
                out = None if band is None else ("u16", band)
        if out is not None:
            observability.count("io: pixels scattered", len(b2))
        return out

    def _bbox(self, s1, e1, s2, e2):
        """Stored (upper-triangle) pixels with bin1 in [s1, e1) and bin2
        in [s2, e2): (bin1, bin2, count) in their stored dtypes."""
        lo, hi = int(self._bin1_offset[s1]), int(self._bin1_offset[e1])
        b1, b2, ct = self._pixels(lo, hi)
        keep = (b2 >= s2) & (b2 < e2)
        return b1[keep], b2[keep], ct[keep]

    def pixels_coo(self, extent1, extent2, balance=False):
        """COO triplets (rows, cols, values) of the rectangle
        [s1, e1) x [s2, e2) of the symmetric map, in local coordinates
        and float64, the stored upper triangle mirrored, balanced with the
        stored weights when ``balance`` (NaN weights give NaN values)
        (``chromosight_tpu/io/cool.py:128-163``)."""
        s1, e1 = extent1
        s2, e2 = extent2
        self._check_balance(balance)
        r1, c1, v1 = self._bbox(s1, e1, s2, e2)
        r2, c2, v2 = self._bbox(s2, e2, s1, e1)
        off_diag = r2 != c2
        rows = np.concatenate([r1.astype(np.int64), c2[off_diag].astype(np.int64)])
        cols = np.concatenate([c1.astype(np.int64), r2[off_diag].astype(np.int64)])
        vals = np.concatenate([v1, v2[off_diag]]).astype(np.float64)
        if balance:
            vals = vals * self._weight[rows] * self._weight[cols]
        return rows - s1, cols - s2, vals

    def trans_coo_raw(self, extent1, extent2, balance=False):
        """COO triplets (rows, cols, values) of a trans rectangle (e1 <=
        s2), which lies wholly in the stored upper triangle, in local
        coordinates: int32 rows and cols, float32 values computed as
        ``count * w[bin1] * w[bin2]`` in float64 when ``balance``; None
        where the ranges overlap.

        The row slice's ``bin2`` and ``count`` are read in their stored
        dtypes (never ``bin1``), and the native ``trans_coo_balanced``
        finds each row's columns in [s2, e2) by two binary searches and
        fills the triplets in one parallel pass
        (``chromosight_tpu/io/cool.py:350-395``); without the native
        library, a numpy filter of the same slice gives the same
        triplets."""
        s1, e1 = extent1
        s2, e2 = extent2
        if e1 > s2:
            return None
        self._check_balance(balance)
        lo, hi = int(self._bin1_offset[s1]), int(self._bin1_offset[e1])
        b2, ct = self._pixels_b2_ct(lo, hi)
        w1 = w2 = None
        if balance:
            w1, w2 = self._weight[s1:e1], self._weight[s2:e2]
        indptr = self._bin1_offset[s1 : e1 + 1]
        observability.count("io: pixels scattered", len(b2))
        with observability.stage("io: scatter"):
            out = native.trans_coo_balanced(indptr, b2, ct, s2, e2, w1, w2)
            if out is not None:
                return out
            rows = np.repeat(np.arange(e1 - s1, dtype=np.int32), np.diff(indptr))
            keep = (b2 >= s2) & (b2 < e2)
            rows, cols, ct = rows[keep], (b2[keep] - s2).astype(np.int32), ct[keep]
            if balance:
                return rows, cols, (
                    ct.astype(np.float64) * w1[rows] * w2[cols]).astype(np.float32)
            return rows, cols, ct.astype(np.float32)

    def _check_balance(self, balance):
        if balance and self._weight is None:
            raise ValueError(
                "No 'weight' column in the contact map; balance it first "
                "or use raw values."
            )

    def row_slice_raw(self, s, e):
        """``(indptr, bin2, count)`` of rows [s, e) in the stored dtypes;
        ``indptr`` is the absolute ``bin1_offset[s : e+1]`` slice."""
        lo, hi = int(self._bin1_offset[s]), int(self._bin1_offset[e])
        b2, ct = self._pixels_b2_ct(lo, hi)
        return self._bin1_offset[s : e + 1], b2, ct

    def pixel_chunks(self, chunksize=10_000_000):
        """Iterate over the pixel table as (int64, int64, float64) chunks."""
        for lo in range(0, self.nnz, int(chunksize)):
            hi = min(lo + int(chunksize), self.nnz)
            b1, b2, ct = self._pixels(lo, hi)
            yield (
                np.asarray(b1, dtype=np.int64),
                np.asarray(b2, dtype=np.int64),
                np.asarray(ct, dtype=np.float64),
            )


class CoolSource(_PixelSource):
    """A single-resolution ``.cool`` file (``file.cool`` or
    ``file.cool::/group``), read with the port's own HDF5 reader
    (``chromosight_torch.io.hdf5``), which stays open while the source
    lives."""

    def __init__(self, path):
        self.path = str(path)
        self.group = "/"
        if "::" in self.path:
            self.path, self.group = self.path.split("::", 1)
        self._file = hdf5.File(self.path)
        g = self._file[self.group]
        binsize = g.attrs.get("bin-size")
        self._chrom_names = [
            n.decode() if isinstance(n, bytes) else str(n) for n in g["chroms/name"][:]
        ]
        self._chrom_offset = g["indexes/chrom_offset"][:].astype(np.int64)
        self._bin1_offset = g["indexes/bin1_offset"][:].astype(np.int64)
        self._bin_chrom_ids = g["bins/chrom"][:].astype(np.int64)
        self._bin_start = g["bins/start"][:].astype(np.int64)
        self._bin_end = g["bins/end"][:].astype(np.int64)
        self._weight = (
            g["bins/weight"][:].astype(np.float64) if "weight" in g["bins"] else None
        )
        self._columns = tuple(g[f"pixels/{c}"] for c in ("bin1_id", "bin2_id", "count"))
        self.info = dict(g.attrs)
        self.binsize = int(binsize) if binsize is not None else None

    def store_weights(self, weights, name="weight", stats=None):
        """Write balancing weights to ``bins/<name>`` of the file, with the
        ``stats`` as its attributes (``ice_balance(..., store=True)``;
        ``chromosight_tpu/io/cool.py:415-428``)."""
        weights = np.asarray(weights, dtype=np.float64)
        if weights.shape[0] != self.n_bins:
            raise ValueError("weights length must equal number of bins")
        with hdf5.File(self.path, "r+") as f:
            f.write_dataset(f"{self.group.rstrip('/')}/bins/{name}", weights, stats)
        self._weight = weights

    @property
    def _count_dtype(self):
        return self._columns[2].dtype.newbyteorder("=")

    def _pixels(self, lo, hi):
        return tuple(_native_order(column[lo:hi]) for column in self._columns)

    def _pixels_b2_ct(self, lo, hi):
        return _native_order(self._columns[1][lo:hi]), _native_order(self._columns[2][lo:hi])


def _native_order(column):
    """A pixel column in the host's byte order (h5py and the reader give a
    big-endian column as stored; the native scatters and ICE read the
    host's order)."""
    if column.dtype.isnative:
        return column
    return column.astype(column.dtype.newbyteorder("="))


class ArraySource(_PixelSource):
    """Chromosome table, bins, upper-triangle pixels and weights held in
    memory.  Pixels must be sorted by (bin1, bin2) with bin1 <= bin2."""

    def __init__(
        self,
        chrom_names,
        chrom_offset,
        bin_start,
        bin_end,
        bin1,
        bin2,
        count,
        weight=None,
        binsize=None,
    ):
        self._chrom_names = [str(c) for c in chrom_names]
        self._chrom_offset = np.asarray(chrom_offset, dtype=np.int64)
        n_bins = int(self._chrom_offset[-1])
        self._bin_chrom_ids = np.repeat(
            np.arange(len(self._chrom_names)), np.diff(self._chrom_offset)
        )
        self._bin_start = np.asarray(bin_start, dtype=np.int64)
        self._bin_end = np.asarray(bin_end, dtype=np.int64)
        self.bin1 = np.asarray(bin1)
        self.bin2 = np.asarray(bin2)
        self.count = np.asarray(count)
        if not (len(self.bin1) == len(self.bin2) == len(self.count)):
            raise ValueError("bin1, bin2 and count must have one length")
        if len(self.bin1) and (
            np.any(np.diff(self.bin1) < 0) or np.any(self.bin2 < self.bin1)
        ):
            raise ValueError("pixels must be upper-triangle, sorted by bin1")
        self._bin1_offset = np.zeros(n_bins + 1, dtype=np.int64)
        np.cumsum(
            np.bincount(self.bin1, minlength=n_bins), out=self._bin1_offset[1:]
        )
        self._weight = (
            None if weight is None else np.asarray(weight, dtype=np.float64)
        )
        self.binsize = None if binsize is None else int(binsize)
        self.planted = []  # (chrom, bin_i, bin_j) of synthetic loops

    @property
    def info(self):
        """The attributes a cool file would hold: its contact total."""
        return {"sum": float(self.count.sum())}

    @property
    def _count_dtype(self):
        return self.count.dtype

    def _pixels(self, lo, hi):
        return self.bin1[lo:hi], self.bin2[lo:hi], self.count[lo:hi]

    def _pixels_b2_ct(self, lo, hi):
        return self.bin2[lo:hi], self.count[lo:hi]

    def store_weights(self, weights, name="weight", stats=None):
        """Keep balancing weights (``ice_balance(..., store=True)``)."""
        weights = np.asarray(weights, dtype=np.float64)
        if weights.shape[0] != self.n_bins:
            raise ValueError("weights length must equal number of bins")
        self._weight = weights

    @classmethod
    def from_source(cls, src):
        """Copy another source's tables into memory (counts keep their
        stored dtype)."""
        bin1, bin2, count = src._pixels(0, src.nnz)
        return cls(
            src.chromnames,
            src._chrom_offset,
            src._bin_start,
            src._bin_end,
            bin1.astype(np.int32),
            bin2.astype(np.int32),
            count,
            weight=src.weights,
            binsize=src.binsize,
        )

    def to_npz(self, path):
        """Write the tables to a compressed ``.npz``."""
        fields = dict(
            chrom_names=np.asarray(self._chrom_names),
            chrom_offset=self._chrom_offset,
            bin_start=self._bin_start,
            bin_end=self._bin_end,
            bin1=self.bin1,
            bin2=self.bin2,
            count=self.count,
            binsize=np.int64(-1 if self.binsize is None else self.binsize),
        )
        if self._weight is not None:
            fields["weight"] = self._weight
        np.savez_compressed(path, **fields)

    @classmethod
    def from_npz(cls, path):
        with np.load(path, allow_pickle=False) as z:
            binsize = int(z["binsize"])
            return cls(
                z["chrom_names"],
                z["chrom_offset"],
                z["bin_start"],
                z["bin_end"],
                z["bin1"],
                z["bin2"],
                z["count"],
                weight=z["weight"] if "weight" in z.files else None,
                binsize=None if binsize < 0 else binsize,
            )

    @classmethod
    def from_synthetic(cls, chroms, bins, seed=0, binsize=5000, trans_density=0.0):
        """``chroms`` chromosomes of ``bins`` bins each, drawn exactly as
        ``tools/make_synthetic_cool.py --chroms C --bins B --seed S
        --trans-density D`` draws them (same ``RandomState`` call sequence:
        the chromosomes, then the uniform trans contacts of every pair),
        then ICE-balanced with ``ice_balance(cis_only=True)``.  Planted
        loop anchors are in ``planted`` as (chrom, bin_i, bin_j), local
        bins."""
        from chromosight_torch.ops.balance import ice_balance

        rng = np.random.RandomState(seed)
        names = [f"chr{c + 1}" for c in range(chroms)]
        b1_parts, b2_parts, ct_parts, planted = [], [], [], []
        for c, name in enumerate(names):
            rows, cols, vals, loops = synth_chrom(bins, rng)
            offset = c * bins
            b1_parts.append((rows + offset).astype(np.int32))
            b2_parts.append((cols + offset).astype(np.int32))
            ct_parts.append(vals)
            planted += [(name, i, j) for i, j in loops]
            del rows, cols, vals
        if trans_density > 0:
            for c1 in range(chroms):
                for c2 in range(c1 + 1, chroms):
                    rows, cols, vals = synth_trans(bins, rng, trans_density)
                    b1_parts.append((rows + c1 * bins).astype(np.int32))
                    b2_parts.append((cols + c2 * bins).astype(np.int32))
                    ct_parts.append(vals)
        start = np.tile(np.arange(bins, dtype=np.int64) * binsize, chroms)
        # the parts stay alive until the source is balanced and returned:
        # freeing them here made every later band fetch of the source ~50%
        # slower on an H100 host (measured with compare_walls.py)
        bin1 = np.concatenate(b1_parts)
        bin2 = np.concatenate(b2_parts)
        count = np.concatenate(ct_parts)
        if trans_density > 0:
            # every part is sorted by (bin1, bin2), and within a row the
            # cis pixels come before the trans pixels of chromosome c2, in
            # increasing c2: a stable sort by bin1 merges them
            order = np.argsort(bin1, kind="stable")
            bin1, bin2, count = bin1[order], bin2[order], count[order]
        src = cls(
            names,
            np.arange(chroms + 1, dtype=np.int64) * bins,
            start,
            start + binsize,
            bin1,
            bin2,
            count,
            binsize=binsize,
        )
        src.planted = planted
        ice_balance(src, cis_only=True, store=True)
        return src


def synth_chrom(n, rng, max_d=600, loop_density=0.001):
    """COO triplets (local, sorted) of one synthetic chromosome and its
    planted loops: ``tools/make_synthetic_cool.py:synth_chrom`` without
    pandas, drawing from ``rng`` in the same order."""
    rows_l, cols_l, vals_l = [], [], []
    for d in range(0, max_d):
        lam = 80.0 / (1 + d) ** 0.8
        keep_p = 0.97 if d < 450 else 0.5
        m = n - d
        sel = rng.rand(m) < keep_p
        idx = np.flatnonzero(sel)
        if len(idx) == 0:
            continue
        counts = rng.poisson(max(lam, 0.5), size=len(idx)) + 1
        rows_l.append(idx)
        cols_l.append(idx + d)
        vals_l.append(counts)
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.concatenate(vals_l).astype(np.float64)
    del rows_l, cols_l, vals_l

    n_loops = max(3, int(n * loop_density))
    loops = []
    extra_r, extra_c, extra_v = [], [], []
    for _ in range(n_loops):
        i = rng.randint(20, n - 420)
        d = rng.randint(40, 400)
        j = i + d
        loops.append((i, j))
        for u in range(-2, 3):
            for v in range(-2, 3):
                w = np.exp(-(u * u + v * v) / 2.0)
                extra_r.append(i + u)
                extra_c.append(j + v)
                extra_v.append(30.0 * w)
    rows = np.concatenate([rows, np.array(extra_r)])
    cols = np.concatenate([cols, np.array(extra_c)])
    vals = np.concatenate([vals, np.array(extra_v)])
    flat = rows * n + cols
    order = np.argsort(flat)
    flat, vals = flat[order], vals[order]
    del rows, cols, order
    uniq, start = np.unique(flat, return_index=True)
    agg = np.add.reduceat(vals, start)
    return (
        (uniq // n).astype(np.int64),
        (uniq % n).astype(np.int64),
        np.round(agg).astype(np.int32),
        loops,
    )


def synth_trans(n, rng, density):
    """Local (rows, cols, int32 counts) of one trans pair's uniform
    contacts, ``int(density * n * n)`` draws with colliding cells summed,
    sorted by (row, col): ``tools/make_synthetic_cool.py:133-156`` without
    pandas, drawing from ``rng`` in the same order."""
    m = int(density * n * n)
    rows = rng.randint(0, n, m).astype(np.int64)
    cols = rng.randint(0, n, m).astype(np.int64)
    counts = rng.poisson(2.0, m) + 1
    flat = rows * n + cols
    order = np.argsort(flat, kind="stable")
    uniq, start = np.unique(flat[order], return_index=True)
    summed = np.add.reduceat(counts[order].astype(np.int64), start)
    return uniq // n, uniq % n, summed.astype(np.int32)


def planted_recall(source, table, tol_bins=2):
    """Share of ``source.planted`` loops with a call of the same chromosome
    within ``tol_bins`` bins on both anchors (``table``: detect output)."""
    if not source.planted:
        raise ValueError("source has no planted loops")
    found = 0
    for chrom, i, j in source.planted:
        start = source.extent(chrom)[0]
        same = table["chrom1"] == chrom
        d1 = np.abs(table["bin1"][same] - start - i)
        d2 = np.abs(table["bin2"][same] - start - j)
        found += bool(np.any((d1 <= tol_bins) & (d2 <= tol_bins)))
    return found / len(source.planted)
