"""The eight BASELINE configuration rows, end to end, on the port.

Counterpart of ``tools/run_baseline_configs.py`` (the rows of
``BASELINE_RESULTS.md:5-14``), in its order:

1. loops ``detect -n raw`` of ``data_test/example.cool``;
2. ``quantify`` of ``data_test/example.bed2`` against it;
3. ``detect -P borders -i 2`` and ``-P hairpins -i 2`` of it;
4. ``detect -n force -m 50000 -M 1000000`` of a copy of the synthetic
   3 x 50,000-bin genome (``--norm force`` stores weights into the file);
5. ``detect --tsvd`` of that genome;
5c. ``detect -I`` of the same genome with trans contacts at 1e-3;
5b. ``detect -I`` of ``data_test/example.cool``.

The two genomes are ``chromosight_torch.bench.genome``'s
(``from_synthetic(3, 50000, seed=0)``, with and without
``trans_density=1e-3``), written on first use, unless their paths are
given.  It prints the table with each row's wall, status and number of
patterns (the rows of the output table); it writes no file besides the
runs' outputs, in a temporary directory.

Run from the root of a checkout: ``python3 -m
chromosight_torch.bench.baseline_configs [genome.cool]
[genome_trans.cool]``; ``main(argv, device="cpu")`` on the CPU,
``main(argv)`` on the card (it raises without one).
"""

from __future__ import annotations

import pathlib
import shutil
import sys
import tempfile
import time
from contextlib import redirect_stdout

from chromosight_torch.bench import device_name
from chromosight_torch.bench.genome import TRANS_DENSITY, ensure_genome
from chromosight_torch.device import resolve_devices

REPO = pathlib.Path(__file__).resolve().parents[2]
EXAMPLE_COOL = REPO / "data_test" / "example.cool"
EXAMPLE_BED2 = REPO / "data_test" / "example.bed2"


def config_rows(workdir, genome=None, genome_trans=None):
    """[(row name, argv, output prefix)] in the JAX runner's order; the
    genome rows only where their genome is given.  Row 4's argv names a
    copy of ``genome`` in ``workdir``, made by ``run_configs``."""
    example, bed2 = str(EXAMPLE_COOL), str(EXAMPLE_BED2)
    rows = [
        ("1 loops detect example.cool (raw norm)",
         ["detect", "--no-plotting", "-n", "raw", example], "c1"),
        ("2 quantify example.bed2", ["quantify", "--no-plotting", bed2, example], "c2"),
    ]
    for pat in ("borders", "hairpins"):
        rows.append((f"3 {pat} detect -i 2",
                     ["detect", "--no-plotting", "-P", pat, "-i", "2", example], f"c3_{pat}"))
    if genome:
        rows.append(("4 genome detect min/max-dist banding, norm=force",
                     ["detect", "--no-plotting", "-n", "force", "-m", "50000", "-M", "1000000",
                      f"{workdir}/genome_force.cool"], "c4"))
        rows.append(("5 genome detect --tsvd", ["detect", "--no-plotting", "--tsvd", str(genome)],
                     "c5"))
    if genome_trans:
        rows.append(("5c genome detect --inter (sparse trans maps)",
                     ["detect", "--no-plotting", "-I", str(genome_trans)], "c5c"))
    rows.append(("5b detect --inter (example.cool)",
                 ["detect", "--no-plotting", "-I", example], "c5b"))
    return [(name, [*argv, f"{workdir}/{prefix}"], f"{workdir}/{prefix}")
            for name, argv, prefix in rows]


def run(argv, device):
    """(wall seconds, status) of one command line through the port."""
    from chromosight_torch.cli.main import main as cli_main

    t0 = time.perf_counter()
    try:
        with redirect_stdout(sys.stderr):
            rc = cli_main(argv, device=device)
        status = "ok" if rc in (None, 0) else f"exit {rc}"
    except SystemExit as exc:
        status = f"exit {exc.code}"
    return time.perf_counter() - t0, status


def count_rows(prefix):
    """The rows of ``prefix``.tsv, or "-" where there is none."""
    import pandas as pd

    path = pathlib.Path(prefix + ".tsv")
    return len(pd.read_csv(path, sep="\t")) if path.exists() else "-"


def run_configs(workdir, genome=None, genome_trans=None, device=None):
    """Run every row of ``config_rows``: [{"name", "argv", "prefix",
    "wall_s", "status", "patterns"}]."""
    results = []
    for name, argv, prefix in config_rows(workdir, genome, genome_trans):
        if name.startswith("4 "):
            # --norm force stores weights: a private copy of the genome
            shutil.copy(genome, argv[-2])
        wall, status = run(argv, device)
        results.append({"name": name, "argv": argv, "prefix": prefix, "wall_s": wall,
                        "status": status, "patterns": count_rows(prefix)})
    return results


def table(results, device):
    """The rows as the JAX runner's markdown table, with the device."""
    lines = [f"Executed by chromosight_torch.bench.baseline_configs on {device}.", "",
             "| config | wall (s) | status | patterns |", "|---|---|---|---|"]
    lines += [f"| {r['name']} | {r['wall_s']:.3f} | {r['status']} | {r['patterns']} |"
              for r in results]
    return "\n".join(lines)


def main(argv=None, device=None):
    """Write the genomes where needed, run the rows and print the table;
    returns the rows."""
    argv = sys.argv[1:] if argv is None else argv
    devices = resolve_devices(device)
    with redirect_stdout(sys.stderr):
        genome = argv[0] if argv else str(ensure_genome(3, 50_000))
        trans = argv[1] if len(argv) > 1 else str(ensure_genome(3, 50_000, TRANS_DENSITY))
    with tempfile.TemporaryDirectory(prefix="chromosight_baseline_") as tmp:
        results = run_configs(tmp, genome, trans, device)
    print(table(results, device_name(devices)), flush=True)
    return results


if __name__ == "__main__":
    main()
