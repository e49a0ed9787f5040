"""The ``.cool`` reader and writer of the Python API.

Counterpart of ``chromosight_tpu/io/cool.py``: ``CoolFile`` (the port's
``CoolSource`` with its chromosome and bin tables as DataFrames),
``load_cool`` and ``create_cool``; ``write_cooler_layout`` writes
cooler's own chunked layout, which the JAX package never writes.  Files
are read and written with the port's own HDF5 code
(``chromosight_torch.io.hdf5``), not h5py; pandas is imported when a
table is built.
"""

from __future__ import annotations

import json

import numpy as np

from chromosight_torch.io import hdf5
from chromosight_torch.io.source import CoolSource


def bins_frame(source):
    """The bin table of a contact source as a DataFrame: chrom
    (categorical, in the chromosome order), start, end (int64) and, where
    the source has weights, weight (``chromosight_tpu/io/cool.py:90-98``)."""
    import pandas as pd

    chrom = pd.Categorical.from_codes(source._bin_chrom_ids, categories=source.chromnames)
    table = {"chrom": chrom, "start": source._bin_start, "end": source._bin_end}
    if source.weights is not None:
        table["weight"] = source.weights
    return pd.DataFrame(table)


class CoolFile(CoolSource):
    """Handle to a single-resolution .cool file (``file.cool`` or
    ``file.cool::/group``): ``CoolSource`` with the tables of
    ``chromosight_tpu.io.cool.CoolFile`` as DataFrames."""

    def __init__(self, path):
        super().__init__(path)
        self._chrom_lengths = self._file[self.group]["chroms/length"][:].astype(np.int64)

    def chroms(self):
        """Chromosome table as a DataFrame (name, length)."""
        import pandas as pd

        return pd.DataFrame({"name": self._chrom_names, "length": self._chrom_lengths})

    def bins(self):
        """Bin table as a DataFrame (chrom, start, end[, weight])."""
        return bins_frame(self)


def load_cool(cool_path):
    """Read a cool file into a whole-genome COO matrix plus metadata tables.

    Mirrors the reference ``utils/io.py:20-78``: returns the upper-triangle
    matrix as a ``scipy.sparse.coo_matrix``, a chromosome table with
    start_bin/end_bin columns, the bin table, and the resolution.

    Returns
    -------
    mat : scipy.sparse.coo_matrix
        Upper-triangle whole genome contact matrix.
    chroms : pandas.DataFrame with name, length, start_bin, end_bin.
    bins : pandas.DataFrame with chrom, start, end.
    bin_size : int
    """
    import scipy.sparse as sp

    clr = CoolFile(cool_path)
    if clr.binsize is None:
        raise ValueError("The cool file must have equally sized bins")
    rows_l, cols_l, vals_l = [], [], []
    for b1, b2, ct in clr.pixel_chunks():
        rows_l.append(b1)
        cols_l.append(b2)
        vals_l.append(ct)
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, np.float64)
    # the upper triangle only: a square file written by another tool may
    # hold both
    keep = cols >= rows
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    n = clr.n_bins
    chroms = clr.chroms()
    chroms["start_bin"] = clr._chrom_offset[:-1]
    chroms["end_bin"] = clr._chrom_offset[1:]
    bins = clr.bins()[["chrom", "start", "end"]]
    mat = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    return mat, chroms, bins, clr.binsize


def _sorted_pairs(b1, b2):
    """Whether the pairs (b1, b2) are in lexicographic order."""
    step1 = np.diff(b1)
    return not np.any((step1 < 0) | ((step1 == 0) & (np.diff(b2) < 0)))


def cool_tables(bins, pixels, assembly="unknown", metadata=None, minimal_dtypes=True):
    """The datasets ({path: array}) and attributes of a single-resolution
    .cool file, as ``create_cool`` writes them (its parameters)."""
    import pandas as pd

    bins = bins.reset_index(drop=True)
    chrom_names = list(pd.unique(bins["chrom"].astype(str)))
    name_to_id = {n: i for i, n in enumerate(chrom_names)}
    chrom_ids = bins["chrom"].astype(str).map(name_to_id).to_numpy(np.int32)
    lengths = (
        bins.groupby(bins["chrom"].astype(str), sort=False)["end"]
        .max()
        .reindex(chrom_names)
        .to_numpy(np.int64)
    )
    n_bins = len(bins)
    chrom_offset = np.zeros(len(chrom_names) + 1, dtype=np.int64)
    np.cumsum(np.bincount(chrom_ids, minlength=len(chrom_names)), out=chrom_offset[1:])

    b1 = np.asarray(pixels["bin1_id"])
    b2 = np.asarray(pixels["bin2_id"])
    ct = np.asarray(pixels["count"])
    if not _sorted_pairs(b1, b2):
        order = np.lexsort((b2, b1))
        b1, b2, ct = b1[order], b2[order], ct[order]
    bin1_offset = np.zeros(n_bins + 1, dtype=np.int64)
    np.cumsum(np.bincount(b1, minlength=n_bins), out=bin1_offset[1:])

    sizes = bins["end"].to_numpy(np.int64) - bins["start"].to_numpy(np.int64)
    binsize = int(np.bincount(sizes).argmax()) if len(sizes) else 0

    id_dtype = (
        np.int32 if minimal_dtypes and n_bins <= np.iinfo(np.int32).max else np.int64
    )
    if (
        minimal_dtypes
        and np.issubdtype(ct.dtype, np.integer)
        and ct.size
        and ct.max() <= np.iinfo(np.int32).max
        and ct.min() >= 0
    ):
        ct = ct.astype(np.int32, copy=False)
    datasets = {
        "chroms/name": np.array(chrom_names, dtype="S32"),
        "chroms/length": lengths.astype(np.int32),
        "bins/chrom": chrom_ids,
        "bins/start": bins["start"].to_numpy(np.int32),
        "bins/end": bins["end"].to_numpy(np.int32),
    }
    if "weight" in bins.columns:
        datasets["bins/weight"] = bins["weight"].to_numpy(np.float64)
    datasets.update({
        "pixels/bin1_id": b1.astype(id_dtype, copy=False),
        "pixels/bin2_id": b2.astype(id_dtype, copy=False),
        "pixels/count": ct,
        "indexes/chrom_offset": chrom_offset,
        "indexes/bin1_offset": bin1_offset,
    })
    attrs = {
        "format": "HDF5::Cooler",
        "format-version": "3",
        "format-url": "https://github.com/mirnylab/cooler",
        "bin-type": "fixed",
        "bin-size": binsize,
        "storage-mode": "symmetric-upper",
        "nbins": n_bins,
        "nchroms": len(chrom_names),
        "nnz": len(b1),
        "sum": float(ct.sum()),
        "genome-assembly": assembly,
        "generated-by": "chromosight-torch",
        "metadata": json.dumps(metadata or {}),
    }
    return datasets, attrs


def create_cool(
    path, bins, pixels, assembly="unknown", metadata=None, minimal_dtypes=True
):
    """Write a minimal single-resolution .cool file
    (``chromosight_tpu/io/cool.py:473-572``, which writes the same
    datasets, dtypes and attributes with h5py; the reference relies on
    ``cooler.create_cooler``), with ``chromosight_torch.io.hdf5``.

    Parameters
    ----------
    path : str
    bins : pandas.DataFrame with columns chrom, start, end (and optionally
        weight).
    pixels : pandas.DataFrame, or a dict of numpy columns, with columns
        bin1_id, bin2_id, count (upper triangle); sorted here by (bin1_id,
        bin2_id) unless they already are.
    minimal_dtypes : bool
        When True (default), pixel id/count columns are stored in the
        narrowest lossless integer dtype (int32 when they fit); pass False
        for the canonical int64 columns ``cooler.create_cooler`` writes.
    """
    datasets, attrs = cool_tables(bins, pixels, assembly, metadata, minimal_dtypes)
    hdf5.write(path, datasets, attrs)
    return path


def chunk_rows(rows, itemsize):
    """The rows of a chunk that h5py picks for a one-dimensional dataset
    of ``rows`` elements of ``itemsize`` bytes (``guess_chunk`` of
    ``h5py/_hl/filters.py``: halve until within half of a target that
    grows with the dataset's size, under 1 MiB)."""
    chunks = float(rows or 1024)
    target = 16 * 1024 * 2 ** np.log10(chunks * itemsize / (1024.0 * 1024))
    target = min(max(target, 8 * 1024), 1024 * 1024)
    while True:
        size = chunks * itemsize
        if (size < target or abs(size - target) / target < 0.5) and size < 1024 * 1024:
            break
        if chunks == 1:
            break
        chunks = np.ceil(chunks / 2.0)
    return int(chunks)


def write_cooler_layout(path, bins, pixels, group="/", pixel_rows=None, columns=None,
                        libver="earliest", compression="gzip", userblock=0, sizes=(8, 8)):
    """Write ``bins`` and ``pixels`` (as ``create_cool`` takes them) in
    cooler's own layout: int64 pixel ids (``minimal_dtypes=False``),
    ``bins/chrom`` an enum of the chromosome names, every dataset chunked
    with shuffle and gzip 6 in the chunks h5py picks (``chunk_rows``; for
    the pixel columns from ``pixel_rows``, the rows cooler created them
    with, by default their length).  ``columns`` {name: float64 array}
    are more bins columns (normalisation vectors: "KR", "VC", ...).
    ``group`` "/resolutions/5000" writes an ``.mcool`` resolution (its
    attributes on the group, the root's those of cooler's ``.mcool``),
    read back as ``path::/resolutions/5000``.  ``libver`` is ``hdf5.write``'s:
    at "earliest" every dataset is unlimited along its axis; at "latest"
    only the pixel columns are (extensible-array chunk indexes), the
    others of fixed size as cooler creates them (fixed-array or
    single-chunk indexes).  ``compression="szip"`` stores every column
    HDF5 takes szip for through shuffle and szip with h5py's default
    options instead of gzip (``hdf5.write``'s).  ``userblock`` and
    ``sizes`` are ``hdf5.write``'s: a user block before the superblock
    (zeros, for the caller's header) and the sizes of offsets and
    lengths.  The port's own chunked
    files, for the tests and the card's smoke run; the JAX package writes
    contiguous ones (``create_cool``)."""
    datasets, attrs = cool_tables(bins, pixels, minimal_dtypes=False)
    names = [n.decode() for n in datasets["chroms/name"]]
    enum = hdf5.enum_dtype({name: i for i, name in enumerate(names)}, np.int32)
    datasets["bins/chrom"] = datasets["bins/chrom"].view(enum)
    for name, column in (columns or {}).items():
        datasets[f"bins/{name}"] = np.asarray(column, np.float64)
    prefix = group.strip("/")
    chunks = {}
    for name, array in datasets.items():
        rows = len(array)
        if name.startswith("pixels/") and pixel_rows is not None:
            rows = pixel_rows
        chunks[f"{prefix}/{name}".strip("/")] = chunk_rows(rows, array.dtype.itemsize)
    datasets = {f"{prefix}/{name}".strip("/"): array for name, array in datasets.items()}
    if prefix:
        root, group_attrs = {"format": "HDF5::MCOOL", "format-version": 2}, {prefix: attrs}
    else:
        root, group_attrs = attrs, {}
    fixed = [name for name in datasets if "/pixels/" not in f"/{name}"] if libver == "latest" \
        else ()
    hdf5.write(path, datasets, root, chunks=chunks, group_attrs=group_attrs, fixed=fixed,
               libver=libver, compression=compression, userblock=userblock, sizes=sizes)
    return path
