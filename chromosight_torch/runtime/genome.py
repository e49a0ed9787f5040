"""Whole-genome runtime on numpy tables: weights, sub-matrices, coordinates.

Counterpart of ``chromosight_tpu/runtime/genome.py:25-262`` for the
intra-chromosomal band path; pandas tables become dicts of numpy columns.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

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
    chromosome on ``device``."""

    def __init__(self, clr, kernel_config, device):
        self.clr = clr
        self.bins = clr.bins()
        self.kernel_config = kernel_config
        self.device = device
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
        """Reuse the stored balancing weights.  Raw maps and ICE
        balancing (``--norm raw|force``, or a map without weights) are
        not ported yet."""
        if norm not in ["auto", "raw", "force"]:
            raise ValueError("norm must be one of: auto, raw, force")
        if norm == "raw":
            raise NotPortedError("--norm raw", 4)
        if "weight" not in self.bins or norm == "force":
            raise NotPortedError(
                "ICE balancing (--norm force, or a map without weights)", 10
            )
        sys.stderr.write("Matrix already balanced, reusing weights\n")
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
