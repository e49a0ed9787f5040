#!/usr/bin/env python3
"""Pattern detection in Hi-C contact maps (PyTorch / CUDA port).

Usage:
    chromosight-torch detect [--kernel-config=FILE] [--pattern=loops]
                        [--pearson=auto] [--win-size=auto] [--iterations=auto]
                        [--win-fmt={json,npy}] [--norm={auto,raw}]
                        [--inter] [--tsvd] [--smooth-trend]
                        [--min-dist=auto] [--max-dist=auto]
                        [--no-plotting] [--min-separation=auto] [--dump=DIR]
                        [--threads=1] [--perc-zero=auto]
                        [--perc-undetected=auto] <contact_map> <prefix>
    chromosight-torch quantify [--inter] [--pattern=loops] [--win-fmt=json]
                        [--kernel-config=FILE] [--norm={auto,raw}]
                        [--threads=1] [--win-size=auto]
                        [--perc-undetected=auto] [--perc-zero=auto]
                        [--no-plotting] [--tsvd] <bed2d> <contact_map> <prefix>

    detect:
        performs pattern detection on a Hi-C contact map via template
        matching: the band engine on intra-chromosomal maps, the dense or
        the tiled engine on inter-chromosomal ones.
    quantify:
        gives a pattern matching score for a list of 2D coordinates on a
        Hi-C contact map.

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
                                map; "raw" scans the raw counts (the
                                weights still tell the missing bins).
                                [default: auto]
    -I, --inter                 Also scan the inter-chromosomal (trans)
                                maps: dense up to 8192 bins a side, by
                                halo tiles on the card above that.
    -V, --tsvd                  Convolve the kernels truncated by SVD to
                                99.9% of their energy.
    -T, --smooth-trend          Fit the distance law by isotonic
                                (non-increasing) regression before
                                detrending; useful on sparse data.
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
    -d DIR, --dump=DIR          Save the matrix after each stage of each
                                map as DIR/<chrom1>-<chrom2>_<stage>.npz
                                (scipy sparse; needs scipy).
    -t INT, --threads=INT       Accepted for compatibility; chromosomes
                                run one after another. [default: 1]
    --no-plotting               Skip the pileup pdf output.

    Configs of several same-shape kernels (borders) run all their kernels
    in one fused launch per chromosome and pass.

Arguments for quantify:
    <bed2d>                     Tab-separated file of coordinate pairs
                                (chrom1 start1 end1 chrom2 start2 end2,
                                with or without header) to score.
    <contact_map>, <prefix>     As for detect.
    Options shared with detect keep their meaning; the scan distance is
    the furthest input pair and min-dist is 0.  Each pair gets the best
    score over the config's kernels; a pair whose window fails
    validation keeps NaN, and every q-value is NaN when any p-value is.
    Inter-chromosomal pairs are scored only with --inter.

Other chromosight-tpu subcommands and options (generate-config,
list-kernels, test, --subsample, --norm force) are not ported yet: see
ROADMAP.md, queue 1.
"""

from __future__ import annotations

import sys

import numpy as np

import chromosight_torch.detection as cid
from chromosight_torch import NotPortedError, __version__
from chromosight_torch.cli.args import CliError, parse_args
from chromosight_torch.device import resolve_device, stage
from chromosight_torch.io.bed2d import load_bed2d
from chromosight_torch.io.config import load_kernel_config
from chromosight_torch.io.source import ArraySource, CoolSource
from chromosight_torch.io.writers import (
    check_prefix_dir,
    progress,
    save_windows,
    write_patterns,
)
from chromosight_torch.preprocessing import resize_kernel
from chromosight_torch.runtime.genome import HicGenome
from chromosight_torch.stats import fdr_correction

DETECT_COLUMNS = [
    "chrom1", "start1", "end1", "chrom2", "start2", "end2",
    "bin1", "bin2", "kernel_id", "iteration", "score", "pvalue", "qvalue",
]
QUANTIFY_COLUMNS = [
    "chrom1", "start1", "end1", "chrom2", "start2", "end2",
    "bin1", "bin2", "score", "pvalue", "qvalue",
]

# subcommand or option -> (what, ROADMAP.md queue-1 item)
NOT_PORTED = {
    "generate-config": ("generate-config", 10),
    "list-kernels": ("list-kernels", 10),
    "test": ("test", 10),
    "--subsample": ("--subsample", 10),
}

TSVD_ENERGY = 0.999


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


def _load_scan_config(args, overrides):
    """The kernel config named by --pattern / --kernel-config with the
    CLI ``overrides`` ({name: (value, cast)}) applied."""
    if args["--kernel-config"] is not None:
        cfg = load_kernel_config(args["--kernel-config"], True)
    else:
        cfg = load_kernel_config(args["--pattern"], False)
    for name, (value, cast) in overrides.items():
        _resolve_config_param(cfg, name, value, cast)
    return cfg


def _resize_config_kernels(cfg, win_size):
    """Resize every kernel of the config to win_size x win_size."""
    win_size = int(win_size)
    if not win_size % 2:
        raise ValueError("--win-size must be odd")
    cfg["kernels"] = [
        resize_kernel(k, factor=win_size / k.shape[0]) for k in cfg["kernels"]
    ]
    return win_size


def scan_config(args):
    """The detect kernel config: the overrides, --win-size and --tsvd."""
    cfg = _load_scan_config(
        args,
        {
            "max_iterations": (args["--iterations"], int),
            "pearson": (args["--pearson"], float),
            "max_dist": (args["--max-dist"], int),
            "min_dist": (args["--min-dist"], int),
            "min_separation": (args["--min-separation"], int),
            "max_perc_undetected": (args["--perc-undetected"], float),
            "max_perc_zero": (args["--perc-zero"], float),
        },
    )
    if args["--win-size"] != "auto":
        _resize_config_kernels(cfg, args["--win-size"])
    cfg["tsvd"] = TSVD_ENERGY if args["--tsvd"] else None
    return cfg


def open_source(path):
    """A contact source for a .cool file or an ArraySource .npz export."""
    if str(path).endswith(".npz"):
        return ArraySource.from_npz(path)
    return CoolSource(path)


def _check_outputs(args):
    """The prefix directory exists and --win-fmt is known."""
    check_prefix_dir(args["<prefix>"])
    if args["--win-fmt"] not in ("npy", "json"):
        sys.stderr.write("Error: --win-fmt must be either json or npy.\n")
        sys.exit(1)


def _concat_tables(tables):
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def _scan(genome, task):
    """``task(contact_map)`` on every chromosome, one after another, each
    map created before and freed after; returns the results in order."""
    subs = genome.sub_mats
    results = []
    for done, sub in enumerate(subs):
        cm = sub.contact_map
        cm.create_mat()
        try:
            results.append(task(cm))
        finally:
            cm.destroy_mat()
        progress(done, len(subs), f"{sub.chr1}-{sub.chr2}")
    return results


def _iterative_scan(genome, cfg):
    """Every (kernel x iteration) pass over all chromosomes, each
    iteration refining its kernel from the pileup of the previous pass
    (reference cli:730-792).  Configs of several same-shape kernels run
    them in one fused launch per chromosome, iteration outermost
    (``chromosight_tpu/cli/main.py:656-693``).  Returns (table, windows)
    in kernel-major order, or (None, None) when nothing was found."""
    total_runs = len(cfg["kernels"]) * cfg["max_iterations"]
    subs = genome.sub_mats
    per_pass = {}

    def collect(kernel_id, iteration, results):
        """Record one pass; the refined kernel, or None if it found
        nothing (which ends that kernel's iterations)."""
        found = [(sub, t, w) for sub, (t, w) in zip(subs, results) if t is not None]
        if not found:
            return None
        table = _concat_tables(
            [genome.get_full_mat_pattern(sub.chr1, sub.chr2, t) for sub, t, _ in found]
        )
        n_rows = len(table["bin1"])
        table["kernel_id"] = np.full(n_rows, kernel_id, dtype=np.int64)
        table["iteration"] = np.full(n_rows, iteration, dtype=np.int64)
        windows = np.concatenate([w for _, _, w in found], axis=0)
        per_pass[(kernel_id, iteration)] = (table, windows)
        return cid.pileup_patterns(windows)

    tsvd = cfg["tsvd"]
    run_id = kernel_id = iteration = 0
    kernels0 = [np.asarray(k) for k in cfg["kernels"]]
    if cid.fuse_kernels_eligible(kernels0):
        current = dict(enumerate(kernels0))
        for iteration in range(cfg["max_iterations"]):
            if not current:
                break
            ids = sorted(current)
            for kernel_id in ids:
                progress(
                    run_id, total_runs, f"Kernel: {kernel_id}, Iteration: {iteration}\n"
                )
            stack = [current[k] for k in ids]
            multi = _scan(genome, lambda cm: cid.detect_multi(cm, cfg, stack, tsvd=tsvd))
            for k_idx, kid in enumerate(ids):
                refined = collect(kid, iteration, [r[k_idx] for r in multi])
                if refined is None:
                    del current[kid]
                else:
                    current[kid] = refined
                    run_id += 1
    else:
        for kernel_id, kernel in enumerate(kernels0):
            for iteration in range(cfg["max_iterations"]):
                progress(
                    run_id, total_runs, f"Kernel: {kernel_id}, Iteration: {iteration}\n"
                )
                results = _scan(
                    genome,
                    lambda cm, k=kernel: cid.pattern_detector(cm, cfg, k, tsvd=tsvd),
                )
                kernel = collect(kernel_id, iteration, results)
                if kernel is None:
                    break  # nothing this pass: skip the remaining iterations
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


def _plot_pileup(windows, cfg, prefix, title):
    from chromosight_torch.plotting import pileup_plot

    pileup = cid.pileup_patterns(windows)
    if not cfg["max_dist"]:
        # diagonal patterns: mirror the windows across the diagonal
        pileup = np.nan_to_num(pileup)
        pileup += pileup.T - np.diag(np.diag(pileup))
    sys.stderr.write(f"Saving pileup plots in {prefix}.pdf\n")
    pileup_plot(pileup, prefix, name=title)


def detect(source, args, device=None):
    """``detect`` on an open contact source with the parsed detect
    options ``args`` (``chromosight_torch.cli.args.parse_args`` of a detect
    command line; ``<contact_map>`` is not read), on ``device``: the first
    CUDA card by default, the CPU only when asked (``"cpu"``).  Writes
    ``<prefix>.tsv`` and the windows, and returns (table, windows), or
    (None, None) when no pattern is found."""
    _refuse_not_ported(args)
    prefix = args["<prefix>"]
    win_fmt = args["--win-fmt"]
    _check_outputs(args)
    device = resolve_device(device)
    cfg = scan_config(args)
    if args["--inter"]:
        sys.stderr.write(
            "WARNING: Detection on interchromosomal matrices is expensive in RAM\n"
        )
    genome = HicGenome(
        source, cfg, device, dump=args["--dump"], smooth=bool(args["--smooth-trend"]),
        inter=bool(args["--inter"]),
    )
    genome.normalize(args["--norm"])
    genome.make_sub_matrices()
    sys.stderr.write("Detecting patterns...\n")
    table, windows = _iterative_scan(genome, cfg)
    if table is None:
        sys.stderr.write("No pattern detected ! Exiting.\n")
        return None, None
    with stage("host: finalize", device):
        table, windows = _finalize(genome, cfg, table, windows)
    sys.stderr.write(f"{len(table['bin1'])} patterns detected\n")
    with stage("host: write", device):
        sys.stderr.write(f"Saving patterns in {prefix}.tsv\n")
        write_patterns(table, prefix)
        sys.stderr.write(f"Saving patterns in {prefix}.{win_fmt}\n")
        save_windows(windows, prefix, fmt=win_fmt)
    if not args["--no-plotting"]:
        _plot_pileup(
            windows, cfg, prefix, f"Pileup of {windows.shape[0]} {cfg['name']}"
        )
    return table, windows


def _positions_for_pair(genome, bed2d, chrom1, chrom2):
    """Rows of the bed2d table on one chromosome pair whose anchor
    midpoints fall in a bin, and their (n, 2) map bins; rows outside the
    matrix are announced and dropped (reference cli:263-292)."""
    rows = np.flatnonzero((bed2d["chrom1"] == chrom1) & (bed2d["chrom2"] == chrom2))
    bins = [
        genome.coords_to_bins(
            bed2d[f"chrom{axis}"][rows],
            (bed2d[f"start{axis}"][rows] + bed2d[f"end{axis}"][rows]) // 2,
        )
        for axis in (1, 2)
    ]
    outside = np.isnan(bins[0]) | np.isnan(bins[1])
    if np.any(outside):
        n_out = int(np.sum(outside))
        sys.stderr.write(
            f"\n{n_out} entr{'ies' if n_out > 1 else 'y'} outside "
            "genomic coordinates of the Hi-C matrix will be ignored.\n"
        )
    starts = (genome.clr.extent(chrom1)[0], genome.clr.extent(chrom2)[0])
    coords = np.stack(
        [bins[axis][~outside] - starts[axis] for axis in (0, 1)], axis=1
    ).astype(np.int64)
    return rows[~outside], coords


def _best_of_kernels(bed2d, scores, pvalues, windows):
    """Across kernels, the highest score of each (chrom1, start1, chrom2,
    start2): the per-kernel tables stacked kernel-major, sorted by score
    (stable, NaN last), and the last row of each coordinate kept, in
    sorted order (``chromosight_tpu/cli/main.py:889-901``).  Returns
    (table, windows)."""
    n_rows = len(bed2d["chrom1"])
    score = np.concatenate(scores)
    order = np.argsort(score, kind="stable")
    row = np.tile(np.arange(n_rows), len(scores))[order]
    ids = {}
    anchors = zip(bed2d["chrom1"], bed2d["start1"], bed2d["chrom2"], bed2d["start2"])
    key = np.array([ids.setdefault(a, len(ids)) for a in anchors], dtype=np.int64)
    _, last_rev = np.unique(key[row][::-1], return_index=True)
    picked = order[np.sort(len(order) - 1 - last_rev)]
    table = {k: np.tile(v, len(scores))[picked] for k, v in bed2d.items()}
    table["score"] = score[picked]
    table["pvalue"] = np.concatenate(pvalues)[picked]
    return table, np.concatenate(windows, axis=0)[picked]


def quantify(source, args, device=None):
    """``quantify`` of the pairs of ``<bed2d>`` on an open contact source
    (``chromosight_tpu/cli/main.py:904-1090``) on ``device`` (the first
    CUDA card by default, the CPU only when asked): each pair scored with
    every kernel of the config at its anchor midpoints, the best score
    kept; trans pairs only with ``--inter``.  Writes ``<prefix>.tsv``
    (rows sorted by bin, NaN where the window fails validation) and the
    windows; returns (table, windows)."""
    _refuse_not_ported(args)
    prefix = args["<prefix>"]
    _check_outputs(args)
    bed2d = load_bed2d(args["<bed2d>"])
    if not args["--inter"] and np.any(bed2d["chrom1"] != bed2d["chrom2"]):
        sys.stderr.write(
            "Warning: The bed2d file contains interchromosomal patterns. "
            "These patterns will not be scanned unless --inter is used.\n"
        )
    device = resolve_device(device)
    cfg = _load_scan_config(
        args,
        {
            "max_perc_zero": (args["--perc-zero"], float),
            "max_perc_undetected": (args["--perc-undetected"], float),
        },
    )
    genome = HicGenome(source, cfg, device, inter=bool(args["--inter"]))
    # scan exactly as far as the furthest requested pair
    furthest = int(np.max(bed2d["start2"] - bed2d["start1"]))
    cfg["max_dist"] = min(furthest, genome.clr.n_bins * genome.clr.binsize)
    cfg["min_dist"] = 0
    cfg["tsvd"] = TSVD_ENERGY if args["--tsvd"] else None
    genome.normalize(args["--norm"])
    km, kn = cfg["kernels"][0].shape
    if args["--win-size"] != "auto":
        km = kn = _resize_config_kernels(cfg, args["--win-size"])
    genome.compute_max_dist()
    genome.make_sub_matrices()

    n_rows = len(bed2d["chrom1"])
    pairs = [
        _positions_for_pair(genome, bed2d, sub.chr1, sub.chr2)
        for sub in genome.sub_mats
    ]
    kernels = [np.asarray(k) for k in cfg["kernels"]]
    # same-shape kernels score every pair in one pass, others one by one
    passes = [kernels] if cid.fuse_kernels_eligible(kernels) else [[k] for k in kernels]
    scores, pvalues, windows = [], [], []
    for stack in passes:
        for kernel_id in range(len(scores), len(scores) + len(stack)):
            progress(kernel_id, len(kernels), f"Kernel: {kernel_id}\n")
        per_kernel = [
            (np.full(n_rows, np.nan), np.full(n_rows, np.nan),
             np.full((n_rows, km, kn), np.nan))
            for _ in stack
        ]
        for sub, (rows, coords) in zip(genome.sub_mats, pairs):
            if not len(rows):
                continue
            cm = sub.contact_map
            cm.create_mat()
            try:
                res = cid.detect_multi(cm, cfg, stack, coords=coords, tsvd=cfg["tsvd"])
            finally:
                cm.destroy_mat()
            for (score, pvalue, wins), (table, w) in zip(per_kernel, res):
                if table is not None:
                    score[rows] = table["score"]
                    pvalue[rows] = table["pvalue"]
                    wins[rows] = w
        for score, pvalue, wins in per_kernel:
            scores.append(score)
            pvalues.append(pvalue)
            windows.append(wins)

    table, windows = _best_of_kernels(bed2d, scores, pvalues, windows)
    for axis in (1, 2):
        bins = genome.coords_to_bins(table[f"chrom{axis}"], table[f"start{axis}"])
        # integers unless a coordinate fell outside the map (pandas' dtype)
        table[f"bin{axis}"] = bins if np.isnan(bins).any() else bins.astype(np.int64)
    table["qvalue"] = fdr_correction(table["pvalue"])
    table = {k: table[k] for k in QUANTIFY_COLUMNS}
    # coordinates whose windows failed validation keep NaN everywhere
    invalid = np.isnan(table["score"])
    table["pvalue"][invalid] = np.nan
    table["qvalue"][invalid] = np.nan
    table = _select(table, np.lexsort((table["bin2"], table["bin1"])))
    with stage("host: write", device):
        write_patterns(table, prefix)
        save_windows(windows, prefix, fmt=args["--win-fmt"])
    if not args["--no-plotting"]:
        _plot_pileup(
            windows, cfg, prefix, f"pileup_of_{windows.shape[0]}_{cfg['name']}"
        )
    return table, windows


def main(argv=None, device=None):
    """Command-line entry point; ``device`` (a ``torch.device`` or name)
    defaults to the first CUDA card, and raises without one: the CPU is
    used only when the caller asks for it (``device="cpu"``)."""
    if argv is None:
        argv = sys.argv[1:]
    try:
        args = parse_args(argv, __doc__, version=f"chromosight-torch {__version__}")
    except CliError as exc:
        return exc.code
    _refuse_not_ported(args)
    if args["quantify"]:
        quantify(open_source(args["<contact_map>"]), args, device)
    else:
        detect(open_source(args["<contact_map>"]), args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
