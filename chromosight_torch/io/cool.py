"""The ``.cool`` reader and writer of the Python API.

Counterpart of ``chromosight_tpu/io/cool.py``: ``CoolFile`` (the port's
``CoolSource`` with its chromosome and bin tables as DataFrames),
``load_cool`` and ``create_cool``.  h5py is imported when a file is
opened or written, pandas when a table is built: the card's machine may
lack h5py, and reads ``.npz`` exports (``io.source.ArraySource``)
instead.
"""

from __future__ import annotations

import json

import numpy as np

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
        with self._h5py.File(self.path, "r") as f:
            self._chrom_lengths = f[self.group]["chroms/length"][:].astype(np.int64)

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


def create_cool(
    path, bins, pixels, assembly="unknown", metadata=None, minimal_dtypes=True
):
    """Write a minimal single-resolution .cool file
    (``chromosight_tpu/io/cool.py:473-572``; the reference relies on
    ``cooler.create_cooler``).

    Parameters
    ----------
    path : str
    bins : pandas.DataFrame with columns chrom, start, end (and optionally
        weight).
    pixels : pandas.DataFrame with columns bin1_id, bin2_id, count
        (upper triangle).
    minimal_dtypes : bool
        When True (default), pixel id/count columns are stored in the
        narrowest lossless integer dtype (int32 when they fit); pass False
        for the canonical int64 columns ``cooler.create_cooler`` writes.
    """
    import h5py
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
    for cid in chrom_ids:
        chrom_offset[cid + 1] += 1
    chrom_offset = np.cumsum(chrom_offset)

    pixels = pixels.sort_values(["bin1_id", "bin2_id"]).reset_index(drop=True)
    b1 = pixels["bin1_id"].to_numpy(np.int64)
    b2 = pixels["bin2_id"].to_numpy(np.int64)
    ct = pixels["count"].to_numpy()
    bin1_offset = np.zeros(n_bins + 1, dtype=np.int64)
    np.add.at(bin1_offset, b1 + 1, 1)
    bin1_offset = np.cumsum(bin1_offset)

    sizes = bins["end"].to_numpy(np.int64) - bins["start"].to_numpy(np.int64)
    binsize = int(np.bincount(sizes).argmax()) if len(sizes) else 0

    with h5py.File(path, "w") as f:
        f.attrs["format"] = "HDF5::Cooler"
        f.attrs["format-version"] = "3"
        f.attrs["format-url"] = "https://github.com/mirnylab/cooler"
        f.attrs["bin-type"] = "fixed"
        f.attrs["bin-size"] = binsize
        f.attrs["storage-mode"] = "symmetric-upper"
        f.attrs["nbins"] = n_bins
        f.attrs["nchroms"] = len(chrom_names)
        f.attrs["nnz"] = len(b1)
        f.attrs["sum"] = float(ct.sum())
        f.attrs["genome-assembly"] = assembly
        f.attrs["generated-by"] = "chromosight-torch"
        f.attrs["metadata"] = json.dumps(metadata or {})
        f.create_dataset("chroms/name", data=np.array(chrom_names, dtype="S32"))
        f.create_dataset("chroms/length", data=lengths.astype(np.int32))
        f.create_dataset("bins/chrom", data=chrom_ids)
        f.create_dataset("bins/start", data=bins["start"].to_numpy(np.int32))
        f.create_dataset("bins/end", data=bins["end"].to_numpy(np.int32))
        if "weight" in bins.columns:
            f.create_dataset("bins/weight", data=bins["weight"].to_numpy(np.float64))
        id_dtype = (
            np.int32
            if minimal_dtypes and n_bins <= np.iinfo(np.int32).max
            else np.int64
        )
        if (
            minimal_dtypes
            and np.issubdtype(ct.dtype, np.integer)
            and ct.size
            and ct.max() <= np.iinfo(np.int32).max
            and ct.min() >= 0
        ):
            ct = ct.astype(np.int32)
        f.create_dataset("pixels/bin1_id", data=b1.astype(id_dtype))
        f.create_dataset("pixels/bin2_id", data=b2.astype(id_dtype))
        f.create_dataset("pixels/count", data=ct)
        f.create_dataset("indexes/chrom_offset", data=chrom_offset)
        f.create_dataset("indexes/bin1_offset", data=bin1_offset)
    return path
