"""Whole-genome runtime: weights, sub-matrices, coordinates.

Counterpart of ``chromosight_tpu/runtime/genome.py:25-262``, with its
signature and its pandas tables: one map per chromosome and, with
``inter``, one per trans pair, in the DataFrame ``sub_mats`` (chr1, chr2,
contact_map).  ICE balancing stays on the host (``ops.balance.
ice_balance``).  The maps go round-robin over the run's devices in map
order.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

from chromosight_torch import observability
from chromosight_torch.device import resolve_devices
from chromosight_torch.io.cool import CoolFile, bins_frame
from chromosight_torch.io.source import ArraySource
from chromosight_torch.io.writers import progress
from chromosight_torch.ops.balance import ice_balance
from chromosight_torch.runtime.contact_map import ContactMap


def open_contacts(path):
    """A contact source for a ``.cool`` file (``CoolFile``) or an
    ``ArraySource`` ``.npz`` export."""
    if str(path).endswith(".npz"):
        return ArraySource.from_npz(path)
    return CoolFile(path)


class HicGenome:
    """A contact map, its bin table, and one ``ContactMap`` per chromosome
    (and, with ``inter``, per trans pair).

    ``path`` is a ``.cool`` file (opened as ``CoolFile``), an
    ``ArraySource`` ``.npz`` export, or an open contact source of
    ``chromosight_torch.io``.  ``dump`` is the ``--dump`` directory
    (created here), ``smooth`` the ``--smooth-trend`` switch, ``sample``
    the ``--subsample`` value (a share of the contacts, or a number of
    contacts above 1).  ``device`` is one ``torch.device`` or name or a
    sequence of them (map i lives on device ``i % len(devices)``); None
    means every visible CUDA card, and raises without one: the CPU is
    used only when asked for (``device="cpu"``).  ``rng`` is the
    ``numpy.random.RandomState`` of the ``--subsample`` draws (None: a
    fresh one, seeded by the OS)."""

    def __init__(
        self, path, inter=False, kernel_config=None, dump=None, smooth=False,
        sample=None, *, device=None, rng=None,
    ):
        self.devices = resolve_devices(device)
        self.device = self.devices[0]
        self.dump = None if dump is None else Path(dump)
        if self.dump is not None:
            os.makedirs(self.dump, exist_ok=True)
        self.clr = open_contacts(path) if isinstance(path, (str, os.PathLike)) else path
        self.bins = bins_frame(self.clr)
        self.kernel_config = kernel_config
        self.smooth = smooth
        self.inter = inter
        self.use_norm = True
        self.sub_mats = None
        self.detectable_bins = np.arange(self.clr.n_bins)
        self.compute_max_dist()
        self.sample = self._sample_share(sample)
        if rng is None and self.sample is not None:
            rng = np.random.RandomState()
        self.rng = rng

    def _sample_share(self, sample):
        """The share of contacts ``--subsample`` keeps, or None
        (``chromosight_tpu/runtime/genome.py:54-74``)."""
        if sample is None:
            return None
        sample = float(sample)
        if "sum" not in self.clr.info:
            raise IOError("sum info missing from cool file. Please fix the file.")
        total = self.clr.info["sum"]
        if sample > total:
            print("sample value is higher than total contacts,skipping subsampling.")
            return None
        if sample > 1:
            return sample / total
        if sample > 0:
            return sample
        raise ValueError("Sample must be a positive value or None")

    def compute_max_dist(self):
        """Scanning distance (bins) from the kernel config
        (reference ``contacts_map.py:166-180``)."""
        try:
            self.max_dist = max(
                self.kernel_config["max_dist"] // self.clr.binsize, 1
            )
            self.largest_kernel = max(
                s.shape[0] for s in self.kernel_config["kernels"]
            )
        except (ValueError, TypeError):
            self.max_dist = None
            self.largest_kernel = 3

    def normalize(self, norm="auto", n_mads=5, threads=1):
        """Reuse the stored balancing weights, or, with ``force`` or on a
        map without weights, compute them by ICE on the host and store them
        in the source (``chromosight_tpu/runtime/genome.py:92-124``): bins
        whose log contact sum lies more than ``n_mads`` median absolute
        deviations below the median get no weight.  ``raw`` scans the raw
        counts and keeps the weights only to tell the detectable bins.
        ``threads`` is accepted for CLI compatibility, as the JAX package
        accepts it: ICE's pool of chromosome blocks has its own size."""
        if norm not in ["auto", "raw", "force"]:
            raise ValueError("norm must be one of: auto, raw, force")
        if "weight" in self.bins.columns and norm != "force":
            sys.stderr.write("Matrix already balanced, reusing weights\n")
        else:
            with observability.stage("balance: ICE"):
                ice_balance(
                    self.clr,
                    mad_max=n_mads,
                    cis_only=not self.inter,
                    ignore_diags=2,
                    max_iters=200,
                    min_nnz=10,
                    store=True,
                )
            print("Whole genome matrix balanced")
            self.bins = bins_frame(self.clr)
        self.use_norm = norm != "raw"
        self.detectable_bins = np.flatnonzero(np.isfinite(self.bins["weight"].to_numpy()))
        print(
            f"Found {len(self.detectable_bins)} / {self.clr.n_bins}"
            " detectable bins"
        )

    def make_sub_matrices(self):
        """The table ``sub_mats`` (chr1, chr2, contact_map) of one
        ``ContactMap`` per chromosome and, with ``inter``, per pair
        chr1 < chr2 in the chromosome order, row-major
        (``chromosight_tpu/runtime/genome.py:126-191``); the maps are not
        created.  Trans maps scan the whole rectangle (no ``max_dist``).
        Map i goes to device ``i % len(devices)``."""
        import pandas as pd

        names = self.clr.chromnames
        d = self.detectable_bins
        pairs = [
            (i1, i2)
            for i1 in range(len(names))
            for i2 in range(len(names))
            if i1 == i2 or (i1 < i2 and self.inter)
        ]
        sys.stderr.write("Preprocessing sub-matrices...\n")
        if self.sample is not None:
            sys.stderr.write(f"{np.round(100 * self.sample)}% contacts will be sampled \n")
        rows = []
        for idx, (i1, i2) in enumerate(pairs):
            chr1, chr2 = names[i1], names[i2]
            (s1, e1), (s2, e2) = self.clr.extent(chr1), self.clr.extent(chr2)
            progress(idx, len(pairs), f"{chr1}-{chr2}")
            detectable = (d[(d >= s1) & (d < e1)] - s1, d[(d >= s2) & (d < e2)] - s2)
            scan = {} if i1 != i2 else dict(
                max_dist=self.max_dist, largest_kernel=self.largest_kernel
            )
            cm = ContactMap(
                self.clr,
                [(s1, e1), (s2, e2)],
                device=self.devices[idx % len(self.devices)],
                name=f"{chr1}-{chr2}",
                detectable_bins=detectable,
                use_norm=self.use_norm,
                smooth=self.smooth,
                dump=self.dump,
                inter=i1 != i2,
                sample=self.sample,
                rng=self.rng,
                devices=self.devices,
                **scan,
            )
            rows.append((chr1, chr2, cm))
        self.sub_mats = pd.DataFrame(rows, columns=["chr1", "chr2", "contact_map"])
        progress(len(pairs), len(pairs), f"{rows[-1][0]}-{rows[-1][1]}\n")
        print("Sub matrices extracted")

    def gather_sub_matrices(self):
        """The created maps assembled into the upper triangle of a
        whole-genome scipy CSR matrix (``chromosight_tpu/runtime/
        genome.py:192-214``)."""
        import scipy.sparse as sp

        rows, cols, vals = [], [], []
        for sub in self.sub_mats.itertuples():
            block = sub.contact_map.matrix
            if block is None:
                continue
            coo = sp.coo_matrix(block)
            rows.append(coo.row.astype(np.int64) + self.clr.extent(sub.chr1)[0])
            cols.append(coo.col.astype(np.int64) + self.clr.extent(sub.chr2)[0])
            vals.append(coo.data)
        if not rows:
            return sp.csr_matrix(self.clr.shape)
        gathered = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=self.clr.shape,
        ).tocsr()
        return sp.triu(gathered)

    def get_full_mat_pattern(self, chr1, chr2, patterns):
        """A copy of a pattern table (a DataFrame, or the command line's
        dict of columns) with its sub-matrix bins shifted to genome bins."""
        out = patterns.copy()
        out["bin1"] = patterns["bin1"] + self.clr.extent(chr1)[0]
        out["bin2"] = patterns["bin2"] + self.clr.extent(chr2)[0]
        return out

    def get_sub_mat_pattern(self, chr1, chr2, patterns):
        """A copy of a pattern table with its genome bins shifted to
        sub-matrix bins."""
        out = patterns.copy()
        out["bin1"] = patterns["bin1"] - self.clr.extent(chr1)[0]
        out["bin2"] = patterns["bin2"] - self.clr.extent(chr2)[0]
        return out

    def bins_to_coords(self, bin_idx):
        """The rows of the bin table (chrom, start, end[, weight]) of
        genome bins."""
        return self.bins.iloc[bin_idx, :]

    def coords_to_bins(self, coords):
        """Genome bins of the (chrom, pos) rows of a DataFrame: the bin of
        the chromosome whose start is ``pos`` rounded down to the bin size
        (``chromosight_tpu/runtime/genome.py:243-262``), as int64, or as
        float64 with NaN where a row has no bin."""
        chroms = np.asarray(coords["chrom"]).astype(str)
        pos = np.asarray(coords["pos"], dtype=np.int64)
        starts = (pos // self.clr.binsize) * self.clr.binsize
        bin_starts = self.bins["start"].to_numpy()
        out = np.full(len(pos), np.nan)
        for chrom in np.unique(chroms):
            if chrom not in self.clr.chromnames:
                continue
            s, e = self.clr.extent(chrom)
            sel = np.flatnonzero(chroms == chrom)
            idx = np.searchsorted(bin_starts[s:e], starts[sel])
            hit = idx < e - s
            hit[hit] = bin_starts[s:e][idx[hit]] == starts[sel][hit]
            out[sel[hit]] = s + idx[hit]
        return out if np.isnan(out).any() else out.astype(np.int64)
