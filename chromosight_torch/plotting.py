"""Pileup heatmaps.

The port's copy of ``pileup_plot`` from ``chromosight_tpu/plotting.py``,
with the same colormap and scale (reference ``plotting.py:11-28``).
matplotlib is imported when a plot is drawn, so runs without it (and
``--no-plotting`` runs) never load it.
"""

from __future__ import annotations

import os

# pileups render on a fixed seismic [0, 2] scale
PILEUP_CMAP, PILEUP_RANGE = "seismic", (0.0, 2.0)


def _plt():
    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    from matplotlib import pyplot as plt

    return plt


def pileup_plot(pileup_pattern, output_prefix, name="pileup_patterns"):
    """Save a pileup heatmap as ``<prefix>.pdf``."""
    plt = _plt()
    fig, ax = plt.subplots()
    vmin, vmax = PILEUP_RANGE
    image = ax.imshow(
        pileup_pattern,
        interpolation="none",
        vmin=vmin,
        vmax=vmax,
        cmap=PILEUP_CMAP,
    )
    ax.set_title(f"{name} pileup")
    ax.set_xlabel(output_prefix)
    fig.colorbar(image, ax=ax)
    fig.savefig(f"{output_prefix}.pdf", dpi=100, format="pdf")
    plt.close(fig)
