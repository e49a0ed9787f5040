"""The check that decides ``correct``: the port's written outputs against
the plain reference, and the card's peaks for the roofline readers.

A check is a module with ``KEY`` (the columns that match rows),
``VALUES`` (the value columns it compares) and
``reference(genome, traffic, inputs, dtype, device, work, map_dtype)``,
the reference's (table, windows) of the cell's command.  This module is
the check of ``detect`` and every traffic file's that names none; one
that names ``"check": "<name>"`` gets ``checks/<name>.py``
(``harness.load_cell`` puts it under the cell's ``checker``).

The port's table (``<prefix>.tsv``) and windows (``<prefix>.json``), as
written by the timed path, are matched row by row with the reference's
on the check's ``KEY``; for ``detect`` (chrom1, start1, chrom2, start2,
bin1, bin2, kernel_id).  The numbers compared, each against the limit
the cell file gives:

* ``unmatched_rows``: rows found in one table only (a call the port
  gained or lost: a threshold decision, a focus, the suppression);
* ``<column>_gap`` for each of ``VALUES`` (``score_gap``,
  ``pvalue_gap``, ``qvalue_gap`` for ``detect``): the largest absolute
  difference over the matched rows, as the table prints them;
* ``window_gap``, where the reference gives windows: the largest
  absolute difference of a window pixel over the matched rows; a pixel
  NaN on one side only counts as ``NAN_GAP``.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

KEY = ("chrom1", "start1", "chrom2", "start2", "bin1", "bin2", "kernel_id")
VALUES = ("score", "pvalue", "qvalue")
NAN_GAP = 1.0e9
PEAKS = pathlib.Path(__file__).parent / "peaks.json"


def compare(table, windows, ref, ref_windows, key=KEY, values=VALUES):
    """{number: value} of the port's (table, windows) against the
    reference's, rows matched on ``key``, ``values`` compared."""
    def keys(t):
        n = len(t[key[0]]) if t is not None else 0
        return {tuple(str(t[k][i]) for k in key): i for i in range(n)}

    pk, rk = keys(table), keys(ref)
    common = sorted(set(pk) & set(rk))
    out = {"unmatched_rows": float(len(set(pk) ^ set(rk)))}
    pi = np.array([pk[c] for c in common], dtype=np.int64)
    ri = np.array([rk[c] for c in common], dtype=np.int64)
    for name in values:
        if len(common):
            a, b = table[name][pi], ref[name][ri]
            gap = np.abs(a - b)
            gap = np.where(np.isnan(a) & np.isnan(b), 0.0, gap)
            gap = np.where(np.isnan(a) != np.isnan(b), NAN_GAP, gap)
            out[f"{name}_gap"] = float(gap.max())
        else:
            out[f"{name}_gap"] = 0.0
    if ref_windows is None:
        return out
    if len(common):
        a, b = windows[pi], ref_windows[ri]
        gap = np.where(np.isnan(a) | np.isnan(b), 0.0, np.abs(a - b))
        gap = np.where(np.isnan(a) != np.isnan(b), NAN_GAP, gap)
        out["window_gap"] = float(gap.max())
    else:
        out["window_gap"] = 0.0
    return out


def reference(genome, traffic, inputs, dtype, device, work, map_dtype):
    """The reference's (table, windows) of the traffic's ``detect``
    command (``reference.detect``)."""
    from perfbench import reference as ref

    return ref.detect(genome, traffic["pattern"], inter=traffic.get("inter", False),
                      dtype=dtype, device=device, work=work, map_dtype=map_dtype)


def reference_of(cell, genome, device, control=False, work=None, inputs=None):
    """The reference's (table, windows) of ``cell``'s command on
    ``genome`` and the traffic's ``inputs`` ({name: path}), through the
    cell's check: in float64, or with ``control`` one step below the
    configuration's precision (the Pearson in float32, the maps in
    bfloat16)."""
    import torch

    dtype, map_dtype = (torch.float32, torch.bfloat16) if control else (torch.float64, None)
    return cell["checker"].reference(genome, cell["traffic_data"], inputs or {}, dtype,
                                     device, work, map_dtype)


def compare_with_reference(cell, genome, table, windows, device, inputs=None):
    """({number: {"value", "limit"}}, work) of the port's outputs against
    the reference of the cell's check, which also counts the band
    kernel's work (``work``)."""
    work = {}
    ref, ref_windows = reference_of(cell, genome, device, work=work, inputs=inputs)
    checker = cell["checker"]
    numbers = compare(table, windows, ref, ref_windows, checker.KEY, checker.VALUES)
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
