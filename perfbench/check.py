"""The check that decides ``correct``: the port's written outputs against
the plain reference, and the card's peaks for the roofline readers.

The port's table (``<prefix>.tsv``) and windows (``<prefix>.json``), as
written by the timed path, are matched row by row with the reference's
on (chrom1, start1, chrom2, start2, bin1, bin2, kernel_id).  The numbers
compared, each against the limit the cell file gives:

* ``unmatched_rows``: rows found in one table only (a call the port
  gained or lost: a threshold decision, a focus, the suppression);
* ``score_gap``, ``pvalue_gap``, ``qvalue_gap``: the largest absolute
  difference over the matched rows, as the table prints them;
* ``window_gap``: the largest absolute difference of a window pixel over
  the matched rows; a pixel NaN on one side only counts as ``NAN_GAP``.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

KEY = ("chrom1", "start1", "chrom2", "start2", "bin1", "bin2", "kernel_id")
NAN_GAP = 1.0e9
PEAKS = pathlib.Path(__file__).parent / "peaks.json"


def compare(table, windows, ref, ref_windows):
    """{number: value} of the port's (table, windows) against the
    reference's."""
    def keys(t):
        n = len(t["bin1"]) if t is not None else 0
        return {tuple(str(t[k][i]) for k in KEY): i for i in range(n)}

    pk, rk = keys(table), keys(ref)
    common = sorted(set(pk) & set(rk))
    out = {"unmatched_rows": float(len(set(pk) ^ set(rk)))}
    pi = np.array([pk[c] for c in common], dtype=np.int64)
    ri = np.array([rk[c] for c in common], dtype=np.int64)
    for name in ("score", "pvalue", "qvalue"):
        if len(common):
            a, b = table[name][pi], ref[name][ri]
            gap = np.abs(a - b)
            gap = np.where(np.isnan(a) & np.isnan(b), 0.0, gap)
            gap = np.where(np.isnan(a) != np.isnan(b), NAN_GAP, gap)
            out[f"{name}_gap"] = float(gap.max())
        else:
            out[f"{name}_gap"] = 0.0
    if len(common):
        a, b = windows[pi], ref_windows[ri]
        gap = np.where(np.isnan(a) | np.isnan(b), 0.0, np.abs(a - b))
        gap = np.where(np.isnan(a) != np.isnan(b), NAN_GAP, gap)
        out["window_gap"] = float(gap.max())
    else:
        out["window_gap"] = 0.0
    return out


def reference_of(cell, genome, device, control=False, work=None):
    """The reference's (table, windows) of ``cell``'s command on
    ``genome``: in float64, or with ``control`` one step below the
    configuration's precision (the Pearson in float32, the maps in
    bfloat16)."""
    import torch

    from perfbench import reference

    traffic = cell["traffic_data"]
    dtype, map_dtype = (torch.float32, torch.bfloat16) if control else (torch.float64, None)
    return reference.detect(genome, traffic["pattern"], inter=traffic.get("inter", False),
                            dtype=dtype, device=device, work=work, map_dtype=map_dtype)


def compare_with_reference(cell, genome, table, windows, device):
    """({number: {"value", "limit"}}, work) of the port's outputs against
    the reference, which also counts the band kernel's work (``work``)."""
    work = {}
    ref, ref_windows = reference_of(cell, genome, device, work=work)
    numbers = compare(table, windows, ref, ref_windows)
    limits = cell["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}, work


def peaks(device):
    """{"fma_per_s", "bytes_per_s"} of the card ``device`` from
    ``peaks.json``, or None for a card it does not list."""
    import torch

    if getattr(device, "type", str(device)) != "cuda":
        return None
    table = json.loads(PEAKS.read_text())
    return table.get(torch.cuda.get_device_name(device))
