#!/usr/bin/env python3
"""Pattern detection in Hi-C contact maps (PyTorch / CUDA port).

Usage:
    chromosight-torch detect [--kernel-config=FILE] [--pattern=loops]
                        [--pearson=auto] [--win-size=auto] [--iterations=auto]
                        [--win-fmt={json,npy}] [--norm=auto]
                        [--min-dist=auto] [--max-dist=auto]
                        [--no-plotting] [--min-separation=auto]
                        [--threads=1] [--perc-zero=auto]
                        [--perc-undetected=auto] <contact_map> <prefix>

    detect:
        performs pattern detection on a Hi-C contact map via template
        matching, with the band engine on every intra-chromosomal map.

Arguments for detect:
    <contact_map>               The Hi-C contact map: a balanced .cool
                                file, or an .npz export of one
                                (chromosight_torch.io.source.ArraySource).
    <prefix>                    Common path prefix of the output files
                                (prefix.tsv, prefix.json, ...).  May
                                include a directory, which must exist.

    -k FILE, --kernel-config=FILE   Custom JSON kernel-config file, instead
                                of a preset.
    -P NAME, --pattern=NAME     Preset pattern configuration [default: loops].
    -p FLOAT, --pearson=FLOAT   Minimum Pearson correlation of a focus
                                seed; "auto" reads the config. [default: auto]
    -W INT, --win-size=INT      Resize the kernels to this odd size;
                                "auto" keeps the preset size. [default: auto]
    -i INT, --iterations=INT    Detection passes, each re-deriving the
                                kernel from the previous pileup. [default: 1]
    -w FMT, --win-fmt=FMT       Windows output: "json" or "npy".
                                [default: json]
    -n NORM, --norm=NORM        "auto" reuses the weights stored in the
                                map (the only mode ported). [default: auto]
    -m INT, --min-dist=INT      Minimum distance (bp) of a reported
                                pattern from the diagonal. [default: auto]
    -M INT, --max-dist=INT      Maximum distance (bp) scanned.
                                [default: auto]
    -S INT, --min-separation=INT  Minimum separation (bp) between two
                                reported patterns. [default: auto]
    -u FLOAT, --perc-undetected=FLOAT  Reject windows with more than this
                                percentage of missing pixels. [default: auto]
    -z FLOAT, --perc-zero=FLOAT Reject windows with more than this
                                percentage of zero pixels. [default: auto]
    -t INT, --threads=INT       Accepted for compatibility; chromosomes
                                run one after another. [default: 1]
    --no-plotting               Skip the pileup pdf output.

Other chromosight-tpu subcommands and options (quantify, generate-config,
list-kernels, test, --dump, --smooth-trend, --tsvd, --subsample, --inter,
--norm raw|force) are not ported yet: see ROADMAP.md, queue 1.
"""

from __future__ import annotations

import sys

import numpy as np

import chromosight_torch.detection as cid
from chromosight_torch import NotPortedError, __version__
from chromosight_torch.device import resolve_device
from chromosight_torch.io.config import load_kernel_config
from chromosight_torch.io.source import ArraySource, CoolSource
from chromosight_torch.io.writers import (
    check_prefix_dir,
    progress,
    save_windows,
    write_patterns,
)
from chromosight_torch.runtime.genome import HicGenome
from chromosight_tpu.cli.args import CliError, parse_args
from chromosight_tpu.preprocessing import resize_kernel
from chromosight_tpu.stats import fdr_correction

DETECT_COLUMNS = [
    "chrom1", "start1", "end1", "chrom2", "start2", "end2",
    "bin1", "bin2", "kernel_id", "iteration", "score", "pvalue", "qvalue",
]

# subcommand or option -> (what, ROADMAP.md queue-1 item)
NOT_PORTED = {
    "quantify": ("quantify", 7),
    "generate-config": ("generate-config", 10),
    "list-kernels": ("list-kernels", 10),
    "test": ("test", 10),
    "--dump": ("--dump", 4),
    "--smooth-trend": ("--smooth-trend", 4),
    "--tsvd": ("--tsvd", 6),
    "--subsample": ("--subsample", 10),
    "--inter": ("--inter", 9),
}


def _refuse_not_ported(args):
    for key, (what, item) in NOT_PORTED.items():
        value = args.get(key)
        if value not in (None, False, "no"):
            raise NotPortedError(what, item)


def _resolve_config_param(cfg, name, cli_value, cast):
    """Merge one CLI override into the kernel config; "auto" defers to
    the config and says so on stderr, as the reference does."""
    if cli_value == "auto":
        if name not in cfg:
            raise KeyError(
                f"{name} is not defined in the config. Please add it to "
                f"the JSON config file, or provide it as a command line option."
            )
        sys.stderr.write(f"{name} set to {cfg[name]} based on config file.\n")
        return
    try:
        cfg[name] = cast(cli_value)
    except ValueError:
        raise ValueError(f'Error: {name} must be a {cast} or "auto"')


def scan_config(args):
    """The kernel config named by --pattern / --kernel-config with the
    detect overrides and --win-size applied."""
    if args["--kernel-config"] is not None:
        cfg = load_kernel_config(args["--kernel-config"], True)
    else:
        cfg = load_kernel_config(args["--pattern"], False)
    overrides = {
        "max_iterations": (args["--iterations"], int),
        "pearson": (args["--pearson"], float),
        "max_dist": (args["--max-dist"], int),
        "min_dist": (args["--min-dist"], int),
        "min_separation": (args["--min-separation"], int),
        "max_perc_undetected": (args["--perc-undetected"], float),
        "max_perc_zero": (args["--perc-zero"], float),
    }
    for name, (value, cast) in overrides.items():
        _resolve_config_param(cfg, name, value, cast)
    if args["--win-size"] != "auto":
        win_size = int(args["--win-size"])
        if not win_size % 2:
            raise ValueError("--win-size must be odd")
        cfg["kernels"] = [
            resize_kernel(k, factor=win_size / k.shape[0]) for k in cfg["kernels"]
        ]
    return cfg


def open_source(path):
    """A contact source for a .cool file or an ArraySource .npz export."""
    if str(path).endswith(".npz"):
        return ArraySource.from_npz(path)
    return CoolSource(path)


def _concat_tables(tables):
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def _detect_sub_mat(sub, cfg, kernel):
    """Detection on one chromosome (reference cli/chromosight.py:601-622)."""
    cm = sub.contact_map
    cm.create_mat()
    try:
        return cid.pattern_detector(cm, cfg, kernel)
    finally:
        cm.destroy_mat()


def _iterative_scan(genome, cfg):
    """Every (kernel x iteration) pass over all chromosomes, one after
    another, each iteration refining its kernel from the pileup of the
    previous pass (reference cli:730-792).  Returns (table, windows) in
    kernel-major order, or (None, None) when nothing was found."""
    total_runs = len(cfg["kernels"]) * cfg["max_iterations"]
    subs = genome.sub_mats
    per_pass = {}
    run_id = kernel_id = iteration = 0
    for kernel_id, kernel in enumerate(cfg["kernels"]):
        for iteration in range(cfg["max_iterations"]):
            progress(
                run_id, total_runs, f"Kernel: {kernel_id}, Iteration: {iteration}\n"
            )
            tables, windows = [], []
            for done, sub in enumerate(subs):
                table, wins = _detect_sub_mat(sub, cfg, kernel)
                progress(done, len(subs), f"{sub.chr1}-{sub.chr2}")
                if table is not None:
                    tables.append(genome.get_full_mat_pattern(sub.chr1, sub.chr2, table))
                    windows.append(wins)
            if not tables:
                break  # nothing this pass: skip the remaining iterations
            table = _concat_tables(tables)
            n_rows = len(table["bin1"])
            table["kernel_id"] = np.full(n_rows, kernel_id, dtype=np.int64)
            table["iteration"] = np.full(n_rows, iteration, dtype=np.int64)
            pass_windows = np.concatenate(windows, axis=0)
            per_pass[(kernel_id, iteration)] = (table, pass_windows)
            kernel = cid.pileup_patterns(pass_windows)
            run_id += 1
    progress(run_id, total_runs, f"Kernel: {kernel_id}, Iteration: {iteration}\n")
    if not per_pass:
        return None, None
    ordered = [per_pass[key] for key in sorted(per_pass)]
    return (
        _concat_tables([t for t, _ in ordered]),
        np.concatenate([w for _, w in ordered], axis=0),
    )


def _select(table, rows):
    return {k: v[rows] for k, v in table.items()}


def _finalize(genome, cfg, table, windows):
    """Neighbour suppression, genomic coordinates, the min_dist and
    p-value filters and FDR q-values (reference cli:805-867)."""
    separation_bins = max(1, int(cfg["min_separation"] // genome.clr.binsize))
    print(f"Minimum pattern separation is : {separation_bins}")
    keep = cid.remove_neighbours(
        table["bin1"], table["bin2"], table["score"], win_size=separation_bins
    )
    table, windows = _select(table, keep), windows[keep]
    for axis in (1, 2):
        coords = genome.bins_to_coords(table[f"bin{axis}"])
        for col, values in coords.items():
            table[f"{col}{axis}"] = values
    too_close = (table["chrom1"] == table["chrom2"]) & (
        np.abs(table["start2"] - table["start1"]) < cfg["min_dist"]
    )
    keep = ~too_close & ~np.isnan(table["pvalue"])
    table, windows = _select(table, keep), windows[keep]
    table["qvalue"] = fdr_correction(table["pvalue"])
    return {k: table[k] for k in DETECT_COLUMNS}, windows


def detect(source, args, device=None):
    """``detect`` on an open contact source with the parsed detect
    options ``args`` (``chromosight_tpu.cli.args.parse_args`` of a detect
    command line; ``<contact_map>`` is not read).  Writes
    ``<prefix>.tsv`` and the windows, and returns (table, windows), or
    (None, None) when no pattern is found."""
    _refuse_not_ported(args)
    prefix = args["<prefix>"]
    win_fmt = args["--win-fmt"]
    check_prefix_dir(prefix)
    if win_fmt not in ("npy", "json"):
        sys.stderr.write("Error: --win-fmt must be either json or npy.\n")
        sys.exit(1)
    device = resolve_device(device)
    cfg = scan_config(args)
    genome = HicGenome(source, cfg, device)
    genome.normalize(args["--norm"])
    genome.make_sub_matrices()
    sys.stderr.write("Detecting patterns...\n")
    table, windows = _iterative_scan(genome, cfg)
    if table is None:
        sys.stderr.write("No pattern detected ! Exiting.\n")
        return None, None
    table, windows = _finalize(genome, cfg, table, windows)
    sys.stderr.write(f"{len(table['bin1'])} patterns detected\n")
    sys.stderr.write(f"Saving patterns in {prefix}.tsv\n")
    write_patterns(table, prefix)
    sys.stderr.write(f"Saving patterns in {prefix}.{win_fmt}\n")
    save_windows(windows, prefix, fmt=win_fmt)
    if not args["--no-plotting"]:
        from chromosight_tpu.plotting import pileup_plot

        pileup = cid.pileup_patterns(windows)
        if not cfg["max_dist"]:
            # diagonal patterns: mirror the windows across the diagonal
            pileup = np.nan_to_num(pileup)
            pileup += pileup.T - np.diag(np.diag(pileup))
        sys.stderr.write(f"Saving pileup plots in {prefix}.pdf\n")
        pileup_plot(
            pileup, prefix, name=f"Pileup of {windows.shape[0]} {cfg['name']}"
        )
    return table, windows


def main(argv=None, device=None):
    """Command-line entry point; ``device`` (a ``torch.device`` or name)
    defaults to the first CUDA card when present, else the CPU."""
    if argv is None:
        argv = sys.argv[1:]
    try:
        args = parse_args(argv, __doc__, version=f"chromosight-torch {__version__}")
    except CliError as exc:
        return exc.code
    _refuse_not_ported(args)
    detect(open_source(args["<contact_map>"]), args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
