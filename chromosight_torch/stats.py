"""Benjamini-Hochberg FDR correction of the final pattern table.

The port's copy of ``fdr_correction`` from ``chromosight_tpu/stats.py``
(reference ``chromosight/utils/stats.py:7-40``).
"""

from __future__ import annotations

import numpy as np


def fdr_correction(pvals):
    """Benjamini-Hochberg adjusted p-values (matches R ``p.adjust``).

    Reference: ``stats.py:7-40``.
    """
    if pvals is None:
        return None
    pvals = np.array(pvals, dtype=np.float64)
    desc = pvals.argsort()[::-1]
    back = desc.argsort()
    steps = float(len(pvals)) / np.arange(len(pvals), 0, -1)
    qvals = np.minimum(1, np.minimum.accumulate(steps * pvals[desc]))
    return qvals[back]
