"""Whole-genome runtime on numpy tables: weights, sub-matrices, coordinates.

Counterpart of ``chromosight_tpu/runtime/genome.py:25-262``: one map per
chromosome and, with ``inter``, one per trans pair; pandas tables become
dicts of numpy columns.  ICE balancing stays on the host
(``ops.balance.ice_balance``).  The maps go round-robin over the run's
devices in map order.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from chromosight_torch import observability
from chromosight_torch.io.writers import progress
from chromosight_torch.ops.balance import ice_balance
from chromosight_torch.runtime.contact_map import ContactMap


@dataclass
class SubMatrix:
    chr1: str
    chr2: str
    contact_map: ContactMap


class HicGenome:
    """A contact source, its bin table, and one ``ContactMap`` per
    chromosome (and, with ``inter``, per trans pair).  ``device`` is one
    ``torch.device`` or a sequence of them: map i lives on device
    ``i % len(devices)``.  ``dump`` is the ``--dump`` directory (created
    here), ``smooth`` the ``--smooth-trend`` switch, ``sample`` the
    ``--subsample`` value (a share of the contacts, or a number of
    contacts above 1) and ``rng`` the ``numpy.random.RandomState`` its
    draws come from (None: a fresh one, seeded by the OS)."""

    def __init__(
        self, clr, kernel_config, device, dump=None, smooth=False, inter=False,
        sample=None, rng=None,
    ):
        self.dump = None if dump is None else Path(dump)
        if self.dump is not None:
            os.makedirs(self.dump, exist_ok=True)
        self.clr = clr
        self.bins = clr.bins()
        self.kernel_config = kernel_config
        single = isinstance(device, (str, torch.device))
        self.devices = tuple(torch.device(d) for d in ([device] if single else device))
        self.device = self.devices[0]
        self.smooth = smooth
        self.inter = inter
        self.use_norm = True
        self.sub_mats = None
        self.detectable_bins = np.arange(clr.n_bins)
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

    def normalize(self, norm="auto", n_mads=5):
        """Reuse the stored balancing weights, or, with ``force`` or on a
        map without weights, compute them by ICE on the host and store them
        in the source (``chromosight_tpu/runtime/genome.py:92-124``): bins
        whose log contact sum lies more than ``n_mads`` median absolute
        deviations below the median get no weight.  ``raw`` scans the raw
        counts and keeps the weights only to tell the detectable bins."""
        if norm not in ["auto", "raw", "force"]:
            raise ValueError("norm must be one of: auto, raw, force")
        if "weight" in self.bins and norm != "force":
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
            self.bins = self.clr.bins()
        self.use_norm = norm != "raw"
        self.detectable_bins = np.flatnonzero(np.isfinite(self.bins["weight"]))
        print(
            f"Found {len(self.detectable_bins)} / {self.clr.n_bins}"
            " detectable bins"
        )

    def make_sub_matrices(self):
        """One ``ContactMap`` per chromosome and, with ``inter``, per pair
        chr1 < chr2 in the chromosome order, row-major
        (``chromosight_tpu/runtime/genome.py:126-191``).  Trans maps scan
        the whole rectangle (no ``max_dist``).  Map i goes to device
        ``i % len(devices)``."""
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
        self.sub_mats = []
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
                self.devices[idx % len(self.devices)],
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
            self.sub_mats.append(SubMatrix(chr1, chr2, cm))
        last = self.sub_mats[-1]
        progress(len(pairs), len(pairs), f"{last.chr1}-{last.chr2}\n")
        print("Sub matrices extracted")

    def gather_sub_matrices(self):
        """The created maps assembled into the upper triangle of a
        whole-genome scipy CSR matrix (``chromosight_tpu/runtime/
        genome.py:192-214``)."""
        import scipy.sparse as sp

        rows, cols, vals = [], [], []
        for sub in self.sub_mats:
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
        """Shift sub-matrix bins of a pattern table to genome bins."""
        out = dict(patterns)
        out["bin1"] = patterns["bin1"] + self.clr.extent(chr1)[0]
        out["bin2"] = patterns["bin2"] + self.clr.extent(chr2)[0]
        return out

    def bins_to_coords(self, bin_idx):
        """(chrom, start, end) columns of genome bins."""
        return {k: self.bins[k][bin_idx] for k in ("chrom", "start", "end")}

    def coords_to_bins(self, chroms, pos):
        """Genome bins (float64, NaN where none) of (chrom, pos) pairs: the
        bin of the chromosome whose start is ``pos`` rounded down to the
        bin size (``chromosight_tpu/runtime/genome.py:243-262``)."""
        chroms = np.asarray(chroms).astype(str)
        pos = np.asarray(pos, dtype=np.int64)
        starts = (pos // self.clr.binsize) * self.clr.binsize
        out = np.full(len(pos), np.nan)
        for chrom in np.unique(chroms):
            if chrom not in self.clr.chromnames:
                continue
            s, e = self.clr.extent(chrom)
            bin_starts = self.bins["start"][s:e]
            sel = np.flatnonzero(chroms == chrom)
            idx = np.searchsorted(bin_starts, starts[sel])
            hit = idx < len(bin_starts)
            hit[hit] = bin_starts[idx[hit]] == starts[sel][hit]
            out[sel[hit]] = s + idx[hit]
        return out
