"""The readings that a cell's limits are set from, on the card.

    python3 perfbench/calibrate.py <cell> [--control N] [--fault NAME] <seed> [<seed> ...]

For each seed, in one process: the cell's genome, file and inputs as a
run makes them (``harness.set_up``), one command of the port, then the
port's outputs against the float64 reference of the cell's check (the
lower reading of each number) and, on the first ``--control`` seeds
(all by default), the control against it: the same
reference one step below the configuration's precision (Pearson in
float32, maps in bfloat16), put in the port's place (the upper reading).
``--fault`` plants one of ``FAULTS`` in the port first, so that the
port's numbers are the fault's readings.  Prints one JSON line per seed.
The benchmark's own runs never run the control or a fault.
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np


def _scaled_tiled_scores(real):
    """The tiled engine's trans scores off by one part in 10^4."""
    def off(*args, **kwargs):
        corr, logp = real(*args, **kwargs)
        corr = corr.copy()
        corr.data *= 1 + 1e-4
        return corr, logp
    return off


def _scaled_band_scores(real):
    """The band kernel's scores off by one part in 10^4."""
    def off(*args, **kwargs):
        corr, logp, cand = real(*args, **kwargs)
        return corr * (1 + 1e-4), logp, cand
    return off


# name: (module, attribute, wrapper of the original)
FAULTS = {
    "tile-scores": ("chromosight_torch.detection", "normxcorr2_sparse_tiled", _scaled_tiled_scores),
    "band-scores": ("chromosight_torch.detection", "band_pearson", _scaled_band_scores),
}


def plant(name):
    """Replace the port's function of fault ``name`` by its faulty wrapper."""
    import importlib

    module, attr, wrap = FAULTS[name]
    mod = importlib.import_module(module)
    setattr(mod, attr, wrap(getattr(mod, attr)))


def rounded(table, columns):
    """The control's table as the port's writer prints it (ten decimals
    in ``columns``, the check's value columns)."""
    out = dict(table)
    for name in columns:
        out[name] = np.round(np.asarray(table[name], np.float64), 10)
    return out


def main(argv):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import torch

    from perfbench import check, harness

    p = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    p.add_argument("cell")
    p.add_argument("seeds", nargs="+", type=int)
    p.add_argument("--control", type=int, default=None)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    cell = harness.load_cell(args.cell)
    if not torch.cuda.is_available():
        harness.log("calibrate needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    if args.fault:
        plant(args.fault)
    key, values = cell["checker"].KEY, cell["checker"].VALUES
    n_control = len(args.seeds) if args.control is None else args.control
    for n, seed in enumerate(args.seeds):
        genome, command, times = harness.set_up(cell, seed, device, [device])
        t = time.perf_counter()
        command()
        times["command"] = time.perf_counter() - t
        genome.to(device)
        table, windows = harness.read_outputs(command.prefix)
        t = time.perf_counter()
        ref, ref_w = check.reference_of(cell, genome, device, inputs=command.inputs)
        times["reference"] = time.perf_counter() - t
        line = {
            "cell": cell["name"], "seed": seed, "fault": args.fault, "rows": len(table[key[0]]),
            "ref_rows": len(ref[key[0]]) if ref else 0,
            "trans_rows": int(np.sum(table["chrom1"] != table["chrom2"])),
            "port": check.compare(table, windows, ref, ref_w, key, values),
        }
        if n < n_control:
            t = time.perf_counter()
            ctl, ctl_w = check.reference_of(cell, genome, device, control=True,
                                            inputs=command.inputs)
            times["control"] = time.perf_counter() - t
            line["control"] = check.compare(rounded(ctl, values), ctl_w, ref, ref_w, key, values)
        line["seconds"] = times
        print(json.dumps(line), flush=True)
        genome = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
