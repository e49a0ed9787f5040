#!/usr/bin/env python3
"""Compare the band-path genome walls of two checkouts of chromosight_torch
on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card, with
another checkout (for example the parent commit unpacked by
``git archive``) in a directory that ``.gitignore`` lists:

    python3 compare_walls.py build/parent

It runs ``detect`` with loops, ``detect`` with borders and ``quantify``
of the planted loops on the synthetic 13 x 48,000-bin genome of
``chip_smoke.py`` with each checkout's package, each in a process of its
own that draws the genome first (set-up, not timed) and then runs each
workload REPS times, in the order other, this, this, other, other, this
(the first run of each process builds its kernels).  Each process prints
one JSON line: per workload the wall and the stages of each run, and the
recall of the planted loops.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

BINSIZE = 5000
REPS = 3
ORDER = ("other", "this", "this", "other", "other", "this")


def run(package_dir):
    """The three genome runs with the package of ``package_dir``."""
    sys.path.insert(0, os.path.abspath(package_dir))
    import torch

    import chromosight_torch
    from chromosight_torch.cli.main import detect, parse_args, quantify
    from chromosight_torch.device import reset_stages, stage_seconds
    from chromosight_torch.io.source import ArraySource, planted_recall

    here = os.path.dirname(os.path.abspath(chromosight_torch.__file__))
    assert here.startswith(os.path.abspath(package_dir)), here
    source = ArraySource.from_synthetic(13, 48_000, seed=0, binsize=BINSIZE)
    workdir = tempfile.mkdtemp()
    bed = f"{workdir}/planted.bed2"
    with open(bed, "w") as handle:
        handle.write("chrom1\tstart1\tend1\tchrom2\tstart2\tend2\n")
        for chrom, i, j in source.planted:
            handle.write(f"{chrom}\t{i * BINSIZE}\t{(i + 1) * BINSIZE}\t"
                         f"{chrom}\t{j * BINSIZE}\t{(j + 1) * BINSIZE}\n")
    runs = {
        "loops": (detect, ["detect", "--no-plotting", "synthetic", f"{workdir}/l"]),
        "borders": (detect, ["detect", "--no-plotting", "--pattern", "borders",
                             "synthetic", f"{workdir}/b"]),
        "quantify": (quantify, ["quantify", "--no-plotting", bed, "synthetic",
                                f"{workdir}/q"]),
    }
    out = {"package": package_dir}
    for name, (fn, argv) in runs.items():
        args = parse_args(argv, "")
        out[name] = {"walls": [], "stages": []}
        for _ in range(REPS):
            reset_stages()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    contextlib.redirect_stderr(io.StringIO()):
                table, _ = fn(source, args, torch.device("cuda"))
            out[name]["walls"].append(time.perf_counter() - t0)
            out[name]["stages"].append(dict(sorted(stage_seconds().items())))
        if name == "loops":
            out[name]["recall"] = planted_recall(source, table)
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run(sys.argv[2])
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    for side in ORDER:
        package_dir = sys.argv[1] if side == "other" else "."
        subprocess.run([sys.executable, __file__, "--run", package_dir], check=True)


if __name__ == "__main__":
    main()
