"""Pileup heatmaps, interactive kernel capture and ASCII kernels.

The port's copies of ``pileup_plot``, ``click_finder`` (with
``_ClickRecorder`` and ``_extract_window``) and ``print_ascii_mat`` from
``chromosight_tpu/plotting.py``, with the same colormaps and scales
(reference ``plotting.py:11-28, 100-249``).  matplotlib is imported when
a plot is drawn, so runs without it (and ``--no-plotting`` runs) never
load it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

# pileups render on a fixed seismic [0, 2] scale, matrices on afmhot_r
# clipped at the 95th percentile
PILEUP_CMAP, PILEUP_RANGE = "seismic", (0.0, 2.0)
MATRIX_CMAP, MATRIX_PERCENTILE = "afmhot_r", 95


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


class _ClickRecorder:
    """Collects matplotlib button-press positions; a position clicked twice
    in a row counts as one double-click."""

    def __init__(self):
        self.raw = []

    def on_press(self, event):
        if event.xdata is None or event.ydata is None:
            return
        pos = (int(event.xdata), int(event.ydata))
        if self.raw and self.raw[-1] == pos:
            print(f"x = {pos[0]}, y = {pos[1]}")
        self.raw.append(pos)

    def double_clicks(self):
        return {b for a, b in zip(self.raw, self.raw[1:]) if a == b}


def _extract_window(dense, center_v, center_h, half_w):
    """Square window around a clicked center, or None when it would cross
    the matrix edge."""
    top, left = center_h - half_w, center_v - half_w
    bottom, right = center_h + half_w + 1, center_v + half_w + 1
    if top < 0 or left < 0 or bottom > dense.shape[0] or right > dense.shape[1]:
        return None
    return dense[top:bottom, left:right]


def click_finder(mat, half_w=8, xlab=None, ylab=None):
    """Show the matrix and record double-clicked windows; returns the
    (n, 2*half_w+1, 2*half_w+1) stack of captured windows."""
    plt = _plt()
    import scipy.sparse as sp

    dense = np.asarray(mat.todense()) if sp.issparse(mat) else np.asarray(mat)

    recorder = _ClickRecorder()
    fig, ax = plt.subplots()
    nonzero = dense[dense != 0]
    ax.imshow(
        dense,
        cmap=MATRIX_CMAP,
        vmax=np.percentile(nonzero, MATRIX_PERCENTILE),
    )
    ax.set_title("Double click to record pattern positions")
    if xlab:
        ax.set_xlabel(xlab)
    if ylab:
        ax.set_ylabel(ylab)
    handler_id = fig.canvas.mpl_connect("button_press_event", recorder.on_press)
    plt.show()
    fig.canvas.mpl_disconnect(handler_id)

    captured = []
    for center_v, center_h in recorder.double_clicks():
        win = _extract_window(dense, center_v, center_h, half_w)
        if win is None:
            sys.stderr.write(
                f"Discarding {(center_v, center_h)}: Too close "
                "to the edge of the matrix\n"
            )
        else:
            captured.append(win)
    side = 2 * half_w + 1
    if not captured:
        return np.zeros((0, side, side))
    return np.stack(captured, axis=0)


# Terminal rendering: ten density glyphs, one per percentile decile, with a
# matching ANSI color ramp (reference plotting.py:178-249 look).
_GLYPH_RAMP = " .,:;ox%#@"
_ANSI_RAMP = (
    "\x1b[37m", "\x1b[37m", "\x1b[36m", "\x1b[36m", "\x1b[32m",
    "\x1b[32m", "\x1b[34m", "\x1b[34m", "\x1b[33m", "\x1b[31m",
)
_ANSI_RESET = "\x1b[0m"


def print_ascii_mat(mat, adjust=True, colored=False, print_str=True):
    """Render a matrix as percentile-quantised ASCII art.

    Each cell maps to one of ten glyphs by its percentile rank within the
    matrix.  ``adjust`` subsamples columns/rows to fit the terminal width;
    ``colored`` adds an ANSI color ramp; with ``print_str=False`` the art
    is returned instead of printed.
    """
    mat = np.asarray(mat)
    if adjust:
        try:
            term_width = (os.get_terminal_size()[0] // 2) - 5
        except OSError:
            term_width = 79
        step = int(max(1, np.ceil(mat.shape[1] / term_width)))
    else:
        step = 1

    # percentile rank -> decile index per cell, on the subsampled grid
    order = np.sort(mat.ravel())
    deciles = (10 * np.searchsorted(order, mat) / order.size).astype(int)
    deciles = deciles[::step, ::step]

    def cell(decile):
        if colored:
            return f"{_ANSI_RAMP[decile]}{_GLYPH_RAMP[decile]}{_ANSI_RESET} "
        return f"{_GLYPH_RAMP[decile]} "

    border = "  " + "- " * (1 + mat.shape[1] // step)
    body = ["  |" + "".join(cell(d) for d in row) + "|" for row in deciles]
    art = "\n".join([border, *body, border]) + "\n"
    if print_str:
        print(art, end="")
        return None
    return art
