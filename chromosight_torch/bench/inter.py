"""Genome-scale ``detect --inter`` (BASELINE 5c): one JSON line a rep.

Counterpart of ``tools/measure_inter.py``: ``detect --no-plotting -I``
of the trans genome (three 50,000-bin chromosomes with trans contacts at
1e-3 of each pair's cells, ``chromosight_torch.bench.genome``'s cached
``genome_trans_50000x3.cool``, written on first use, or the file given)
through the port's command line, ``reps`` times in one process: each
rep's exit code, wall, number of calls, stages, link bytes and compute
accounting per program family, and the device it ran on.

Run from the root of a checkout: ``python3 -m chromosight_torch.bench.inter
[trans_genome.cool] [reps]``; ``main(argv, device="cpu")`` on the CPU,
``main(argv)`` on the card (it raises without one).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from contextlib import redirect_stdout

from chromosight_torch import observability as obs
from chromosight_torch.bench import device_name
from chromosight_torch.bench.genome import TRANS_DENSITY, ensure_genome
from chromosight_torch.device import resolve_devices


def main(argv=None, device=None):
    """Run the reps, printing one JSON line after each; returns the
    records."""
    argv = sys.argv[1:] if argv is None else argv
    devices = resolve_devices(device)
    with redirect_stdout(sys.stderr):
        cool = argv[0] if argv else str(ensure_genome(3, 50_000, TRANS_DENSITY))
    reps = int(argv[1]) if len(argv) > 1 else 2

    from chromosight_torch.cli.main import main as cli_main

    records = []
    with tempfile.TemporaryDirectory(prefix="inter_measure_") as tmp:
        for rep in range(reps):
            obs.reset()
            prefix = os.path.join(tmp, f"out{rep}")
            t0 = time.perf_counter()
            with redirect_stdout(sys.stderr):
                rc = cli_main(["detect", "--no-plotting", "-I", cool, prefix], device=device)
            wall = time.perf_counter() - t0
            stages, _counts, bytes_ = obs.snapshot()
            comp = obs.compute_snapshot()
            n_calls = 0
            if os.path.exists(prefix + ".tsv"):
                with open(prefix + ".tsv") as handle:
                    n_calls = sum(1 for _ in handle) - 1
            record = {
                "rep": rep,
                "rc": rc,
                "wall_s": round(wall, 2),
                "calls": n_calls,
                "stage_s": {k: round(v, 3) for k, v in sorted(stages.items())},
                "bytes_MB": {k: round(v / 1e6, 1) for k, v in bytes_.items()},
                "compute": {
                    k: {
                        "flops_T": round(v["flops"] / 1e12, 3),
                        "hbm_min_GB": round(v["hbm_min_bytes"] / 1e9, 3),
                        "dispatches": v["dispatches"],
                    }
                    for k, v in sorted(comp.items())
                },
                "device": device_name(devices),
            }
            records.append(record)
            print(json.dumps(record), flush=True)
    return records


if __name__ == "__main__":
    main()
