"""2D BED parsing.

Counterpart of ``chromosight_tpu/io/bed2d.py``: the first six
tab-separated columns of a file of genomic interval pairs (chrom1 start1
end1 chrom2 start2 end2), with a header line or without one, as
``csv.Sniffer`` decides from the first 64 KiB.  Intra-chromosomal pairs
are swapped so that start1 <= start2.  ``read_bed2d`` gives the dict of
numpy columns the command line works on, ``load_bed2d`` the JAX
package's DataFrame.
"""

from __future__ import annotations

import csv

import numpy as np

BED2D_COLUMNS = ["chrom1", "start1", "end1", "chrom2", "start2", "end2"]


def read_bed2d(path):
    """Dict of numpy columns (chrom1/chrom2 str, starts and ends int64)
    in file order."""
    with open(path) as handle:
        text = handle.read()
    has_header = csv.Sniffer().has_header(text[:65536])
    rows = [line.split("\t") for line in text.splitlines() if line.strip()]
    names = BED2D_COLUMNS
    if has_header:
        names, rows = [c.strip() for c in rows[0][:6]], rows[1:]
    cols = {name: [r[i].strip() for r in rows] for i, name in enumerate(names)}
    table = {}
    for name in BED2D_COLUMNS:
        if name.startswith("chrom"):
            table[name] = np.asarray(cols[name], dtype=str)
        else:
            table[name] = np.asarray(cols[name], dtype=np.int64)
    flipped = (table["start2"] < table["start1"]) & (
        table["chrom1"] == table["chrom2"]
    )
    for col in ("start", "end"):
        a, b = table[f"{col}1"].copy(), table[f"{col}2"].copy()
        table[f"{col}1"] = np.where(flipped, b, a)
        table[f"{col}2"] = np.where(flipped, a, b)
    return table


def load_bed2d(path):
    """The pairs of a 2D BED file as a DataFrame of the six columns
    (``chromosight_tpu/io/bed2d.py:10-39``)."""
    import pandas as pd

    return pd.DataFrame(read_bed2d(path))
