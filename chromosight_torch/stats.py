"""Fisher-transform p-values and the Benjamini-Hochberg FDR correction.

The port's copies of ``fdr_correction`` and ``corr_to_pval`` from
``chromosight_tpu/stats.py`` (reference ``chromosight/utils/stats.py``).
The device paths compute their p-values inside the Pearson; these host
versions serve the public API and the q-values of the final table.
scipy is imported by ``corr_to_pval`` when it runs.
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


def corr_to_pval(corr, n, rho0=0):
    """Two-sided log10 p-values for Pearson coefficients via the Fisher
    z-transformation.

    Reference: ``stats.py:43-81``.
    """
    import scipy.stats as ss

    corr = np.asarray(corr, dtype=np.float64)
    if isinstance(n, (int, np.integer)):
        n = np.full(corr.shape, n, dtype=np.float64)
    else:
        n = np.asarray(n, dtype=np.float64)
        if n.shape != corr.shape:
            raise ValueError("corr and n must have identical shapes.")
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.arctanh(corr) - np.arctanh(rho0)
        pvals = 2 * ss.norm().cdf(-np.abs(z * np.sqrt(n - 3)))
        return np.log10(pvals)
