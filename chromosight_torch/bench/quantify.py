"""Genome-scale quantify of the planted loops, twice: one JSON line.

Counterpart of ``tools/bench_quantify.py``: ``quantify --no-plotting
--threads 4`` of the bench genome's truth coordinates (its
``.truth.bed2d``, 624 planted loops at the default size) through the
port's command line, twice in one process; both walls, the second as the
steady state, the number of coordinates and of scored ones, their median
score, the stages and link bytes of the second run, and the device it
ran on.  The genome is ``chromosight_torch.bench.genome``'s cached one
(generated on first use).

Run from the root of a checkout: ``python3 -m
chromosight_torch.bench.quantify``; ``main(device="cpu")`` runs on the
CPU, ``main()`` on the card (it raises without one).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np

from chromosight_torch import observability as obs
from chromosight_torch.bench import device_name
from chromosight_torch.bench.genome import ensure_genome, truth_path
from chromosight_torch.device import resolve_devices


def run_quantify(cool_path, bed2d, prefix, device):
    """``quantify --no-plotting --threads 4`` through the port's command
    line, its standard output sent to stderr."""
    from chromosight_torch.cli.main import main as cli_main

    argv = ["quantify", "--no-plotting", "--threads", "4", str(bed2d), str(cool_path),
            str(prefix)]
    with redirect_stdout(sys.stderr):
        rc = cli_main(argv, device=device)
    if rc not in (None, 0):
        raise RuntimeError(f"quantify exited {rc}")


def measure(device=None):
    """The record ``main`` prints."""
    import pandas as pd

    devices = resolve_devices(device)
    cool_path = ensure_genome()
    truth = truth_path(cool_path)
    walls = []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(2):
            obs.reset()
            t0 = time.perf_counter()
            run_quantify(cool_path, truth, os.path.join(tmp, f"q{rep}"), device)
            walls.append(time.perf_counter() - t0)
        stages, _counts, byte_totals = obs.snapshot()
        out = pd.read_csv(os.path.join(tmp, "q1.tsv"), sep="\t")
    return {
        "metric": "genome-scale quantify (truth coords, cool->tsv)",
        "walls_s": [round(w, 2) for w in walls],
        "steady_state_s": round(walls[-1], 2),
        "n_coords": int(len(out)),
        "n_scored": int(out["score"].notna().sum()),
        "median_score": round(float(np.nanmedian(out["score"])), 3),
        "stage_s": {k: round(v, 3) for k, v in sorted(stages.items())},
        "upload_MB": round(byte_totals.get("upload", 0) / 1e6, 1),
        "download_MB": round(byte_totals.get("download", 0) / 1e6, 1),
        "device": device_name(devices),
    }


def main(device=None):
    """Run both passes and print the JSON line (the rest goes to stderr)."""
    with redirect_stdout(sys.stderr):
        record = measure(device)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
