"""Whole-genome runtime on numpy tables: weights, sub-matrices, coordinates.

Counterpart of ``chromosight_tpu/runtime/genome.py:25-262`` for the
intra-chromosomal band path; pandas tables become dicts of numpy columns.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from chromosight_torch import NotPortedError
from chromosight_torch.io.writers import progress
from chromosight_torch.runtime.contact_map import ContactMap


@dataclass
class SubMatrix:
    chr1: str
    chr2: str
    contact_map: ContactMap


class HicGenome:
    """A contact source, its bin table, and one ``ContactMap`` per
    chromosome on ``device``; ``dump`` is the ``--dump`` directory
    (created here) and ``smooth`` the ``--smooth-trend`` switch."""

    def __init__(self, clr, kernel_config, device, dump=None, smooth=False):
        self.dump = None if dump is None else Path(dump)
        if self.dump is not None:
            os.makedirs(self.dump, exist_ok=True)
        self.clr = clr
        self.bins = clr.bins()
        self.kernel_config = kernel_config
        self.device = device
        self.smooth = smooth
        self.use_norm = True
        self.sub_mats = None
        self.detectable_bins = np.arange(clr.n_bins)
        self.compute_max_dist()

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

    def normalize(self, norm="auto"):
        """Reuse the stored balancing weights; ``raw`` scans the raw
        counts and keeps the weights only to tell the detectable bins.
        ICE balancing (``--norm force``, or a map without weights) is not
        ported yet."""
        if norm not in ["auto", "raw", "force"]:
            raise ValueError("norm must be one of: auto, raw, force")
        if "weight" not in self.bins or norm == "force":
            raise NotPortedError(
                "ICE balancing (--norm force, or a map without weights)", 10
            )
        sys.stderr.write("Matrix already balanced, reusing weights\n")
        self.use_norm = norm != "raw"
        self.detectable_bins = np.flatnonzero(np.isfinite(self.bins["weight"]))
        print(
            f"Found {len(self.detectable_bins)} / {self.clr.n_bins}"
            " detectable bins"
        )

    def make_sub_matrices(self):
        """One intra-chromosomal ``ContactMap`` per chromosome."""
        names = self.clr.chromnames
        d = self.detectable_bins
        sys.stderr.write("Preprocessing sub-matrices...\n")
        self.sub_mats = []
        for idx, chrom in enumerate(names):
            s, e = self.clr.extent(chrom)
            progress(idx, len(names), f"{chrom}-{chrom}")
            local = d[(d >= s) & (d < e)] - s
            cm = ContactMap(
                self.clr,
                [(s, e), (s, e)],
                self.device,
                name=f"{chrom}-{chrom}",
                detectable_bins=(local, local),
                max_dist=self.max_dist,
                largest_kernel=self.largest_kernel,
                use_norm=self.use_norm,
                smooth=self.smooth,
                dump=self.dump,
            )
            self.sub_mats.append(SubMatrix(chrom, chrom, cm))
        progress(len(names), len(names), f"{names[-1]}-{names[-1]}\n")
        print("Sub matrices extracted")

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
