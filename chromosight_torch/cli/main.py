#!/usr/bin/env python3
"""Pattern detection in Hi-C contact maps (PyTorch / CUDA port).

Usage:
    chromosight-torch detect [--kernel-config=FILE] [--pattern=loops]
                        [--pearson=auto] [--win-size=auto] [--iterations=auto]
                        [--win-fmt={json,npy}] [--norm={auto,raw,force}]
                        [--subsample=no] [--inter] [--tsvd] [--smooth-trend]
                        [--n-mads=5] [--min-dist=auto] [--max-dist=auto]
                        [--no-plotting] [--min-separation=auto] [--dump=DIR]
                        [--threads=1] [--perc-zero=auto]
                        [--perc-undetected=auto] <contact_map> <prefix>
    chromosight-torch generate-config [--preset loops] [--click contact_map]
                        [--norm={auto,raw,force}] [--win-size=auto]
                        [--n-mads=5] [--chroms=CHROMS] [--inter]
                        [--threads=1] <prefix>
    chromosight-torch quantify [--inter] [--pattern=loops] [--subsample=no]
                        [--win-fmt=json] [--kernel-config=FILE]
                        [--norm={auto,raw,force}] [--threads=1] [--n-mads=5]
                        [--win-size=auto] [--perc-undetected=auto]
                        [--perc-zero=auto] [--no-plotting] [--tsvd]
                        <bed2d> <contact_map> <prefix>
    chromosight-torch list-kernels [--long] [--mat] [--name=kernel_name]
    chromosight-torch test

    detect:
        performs pattern detection on a Hi-C contact map via template
        matching: the band engine on intra-chromosomal maps, the dense or
        the tiled engine on inter-chromosomal ones.
    quantify:
        gives a pattern matching score for a list of 2D coordinates on a
        Hi-C contact map.
    generate-config:
        writes a preset (or an interactively captured) kernel config: a
        JSON file of parameters and one text file per kernel matrix.
    list-kernels:
        prints the preset kernels.
    test:
        runs loop detection on the example map and compares its log with
        the golden record.  It tries to download the map first, and falls
        back to the copy in the repository (data_test/example.cool).

Arguments for detect:
    <contact_map>               The Hi-C contact map: a .cool file, or an
                                .npz export of one
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
                                map and balances it (ICE, on the host)
                                when it has none; "raw" scans the raw
                                counts (the weights still tell the missing
                                bins); "force" recomputes the ICE weights
                                and overwrites the file's. [default: auto]
    -s FLOAT, --subsample=FLOAT Use only this share of the contacts (or,
                                above 1, this many), drawn anew for each
                                map and pass. [default: no]
    -I, --inter                 Also scan the inter-chromosomal (trans)
                                maps: dense up to 8192 bins a side, by
                                halo tiles on the card above that.
    -V, --tsvd                  Convolve the kernels truncated by SVD to
                                99.9% of their energy.
    -T, --smooth-trend          Fit the distance law by isotonic
                                (non-increasing) regression before
                                detrending; useful on sparse data.
    -N FLOAT, --n-mads=FLOAT    When balancing, bins whose log contact sum
                                is more than this many median absolute
                                deviations below the median get no weight.
                                [default: 5]
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
    -t INT, --threads=INT       Per-map workers in all: 1 runs the maps
                                one after another; N > 1 fetches and
                                preprocesses the maps on the calling
                                thread, in map order, up to N - 1 maps
                                ahead, while N worker threads scan them,
                                each on a stream of its own. [default: 1]
    --no-plotting               Skip the pileup pdf output.

    Configs of several same-shape kernels (borders) run all their kernels
    in one fused launch per chromosome and pass.  The maps go round-robin
    over the devices the caller gives (``main(argv, device=[...])``; by
    default every visible CUDA card), as do the tile batches of a trans
    map; the outputs do not depend on the devices or on --threads.

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

Arguments for generate-config:
    <prefix>                    Path prefix of the generated config
                                (prefix.json and prefix.N.txt kernels).
    -e NAME, --preset=NAME      Preset config to start from.
                                [default: loops]
    -c FILE, --click=FILE       Build the kernel interactively instead:
                                shows the contact map FILE and records
                                double-clicked windows, whose gaussian-
                                blurred pileup becomes the kernel.
    -C LIST, --chroms=LIST      Comma-separated chromosomes to show in
                                --click mode.

Arguments for list-kernels:
    --long                      Also print each preset's parameters.
    --mat                       Draw each kernel matrix as ASCII art.
    --name=NAME                 Only this kernel. [default: all]
"""

from __future__ import annotations

import http.client
import io
import itertools
import json
import os
import pathlib
import sys
import tempfile
from contextlib import contextmanager

import numpy as np

import chromosight_torch.detection as cid
from chromosight_torch import __version__, observability
from chromosight_torch.cli.args import CliError, parse_args
from chromosight_torch.device import resolve_devices, stage
from chromosight_torch.io.bed2d import read_bed2d
from chromosight_torch.io.config import load_kernel_config
from chromosight_torch.io.writers import (
    check_prefix_dir,
    download_file,
    progress,
    save_windows,
    write_patterns,
)
from chromosight_torch.kernels import kernel_names
from chromosight_torch.parallel import MapScheduler, destroy_maps, retain_maps
from chromosight_torch.preprocessing import resize_kernel
from chromosight_torch.runtime.genome import HicGenome, open_contacts
from chromosight_torch.stats import fdr_correction

DETECT_COLUMNS = [
    "chrom1", "start1", "end1", "chrom2", "start2", "end2",
    "bin1", "bin2", "kernel_id", "iteration", "score", "pvalue", "qvalue",
]
QUANTIFY_COLUMNS = [
    "chrom1", "start1", "end1", "chrom2", "start2", "end2",
    "bin1", "bin2", "score", "pvalue", "qvalue",
]

LOGO = np.loadtxt(pathlib.Path(__file__).parent / "logo.txt")
URL_EXAMPLE_DATASET = (
    "https://raw.githubusercontent.com/koszullab/"
    "chromosight/master/data_test/example.cool"
)
REPO_ROOT = pathlib.Path(__file__).parents[2]
# the self-test's fallback when the download fails: the example map in
# the repository, or the file CHROMOSIGHT_TPU_TEST_COOL names (the JAX
# package's variable, chromosight_tpu/cli/main.py:177-182)
LOCAL_EXAMPLE_DATASET = os.environ.get(
    "CHROMOSIGHT_TPU_TEST_COOL", str(REPO_ROOT / "data_test" / "example.cool")
)

# Golden log of the self-test: the lines of chromosight_tpu/cli/main.py
# TEST_LOG (the reference's, cli/chromosight.py:185-199).
TEST_LOG = f"""Fetching test dataset at {URL_EXAMPLE_DATASET}...
Running detection on test dataset...
pearson set to 0.3 based on config file.
max_dist set to 2000000 based on config file.
min_dist set to 20000 based on config file.
min_separation set to 5000 based on config file.
max_perc_undetected set to 50.0 based on config file.
max_perc_zero set to 10.0 based on config file.
Matrix already balanced, reusing weights
Preprocessing sub-matrices...
Detecting patterns...
89 patterns detected
Saving patterns in chromosight_test.tsv
Saving patterns in chromosight_test.json
"""

TSVD_ENERGY = 0.999


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


def _check_outputs(args):
    """The prefix directory exists and --win-fmt is known."""
    check_prefix_dir(args["<prefix>"])
    if args["--win-fmt"] not in ("npy", "json"):
        sys.stderr.write("Error: --win-fmt must be either json or npy.\n")
        sys.exit(1)


def _concat_tables(tables):
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def _scan(genome, scheduler, task, keep):
    """``task(contact_map)`` on every map of the genome through the
    scheduler (maps kept created after their task when ``keep``); the
    results in map order, progress drawn as each comes."""
    subs = list(genome.sub_mats.itertuples())
    items = [(i, sub.contact_map) for i, sub in enumerate(subs)]
    results = []
    for done, result in enumerate(scheduler.scan(items, task, keep=keep)):
        results.append(result)
        progress(done, len(subs), f"{subs[done].chr1}-{subs[done].chr2}")
    return results


def _iterative_scan(genome, cfg, scheduler):
    """Every (kernel x iteration) pass over all chromosomes, each
    iteration refining its kernel from the pileup of the previous pass
    (reference cli:730-792).  Configs of several same-shape kernels run
    them in one fused launch per chromosome, iteration outermost
    (``chromosight_tpu/cli/main.py:656-693``).  With several passes the
    maps stay created between them (``retain_maps``).  Returns (table,
    windows) in kernel-major order, or (None, None) when nothing was
    found."""
    total_runs = len(cfg["kernels"]) * cfg["max_iterations"]
    subs = list(genome.sub_mats.itertuples())
    keep = retain_maps(genome, total_runs)
    per_pass = {}

    def collect(kernel_id, iteration, results):
        """Record one pass; the refined kernel, or None if it found
        nothing (which ends that kernel's iterations)."""
        found = [(sub, t, w) for sub, (t, w) in zip(subs, results) if t is not None]
        if not found:
            return None
        with observability.stage("scan: collect"):
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
            multi = _scan(
                genome,
                scheduler,
                lambda cm: cid.detect_multi(cm, cfg, stack, dump=genome.dump, tsvd=tsvd),
                keep,
            )
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
                    scheduler,
                    lambda cm, k=kernel: cid.pattern_detector(
                        cm, cfg, k, dump=genome.dump, full=True, tsvd=tsvd
                    ),
                    keep,
                )
                kernel = collect(kernel_id, iteration, results)
                if kernel is None:
                    break  # nothing this pass: skip the remaining iterations
                run_id += 1
    progress(run_id, total_runs, f"Kernel: {kernel_id}, Iteration: {iteration}\n")
    if keep:
        destroy_maps(genome)
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
    keep = cid.remove_neighbours(table, win_size=separation_bins)
    table, windows = _select(table, keep), windows[keep]
    for axis in (1, 2):
        coords = genome.bins_to_coords(table[f"bin{axis}"])
        for col in ("chrom", "start", "end"):
            table[f"{col}{axis}"] = coords[col].to_numpy(dtype=str if col == "chrom" else None)
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


def _parse_subsample(value):
    return None if value == "no" else value


def _open_genome(source, args, cfg, devices, rng, **kw):
    """The genome of a detect or quantify run on ``devices``, its maps'
    ``--subsample`` draws from ``rng``, and the scheduler of
    ``--threads`` over its devices."""
    with observability.stage("genome: open"):
        genome = HicGenome(
            source, inter=bool(args["--inter"]), kernel_config=cfg,
            sample=_parse_subsample(args["--subsample"]), device=devices, rng=rng, **kw,
        )
    return genome, MapScheduler(genome.devices, int(args["--threads"]))


def detect(source, args, device=None, rng=None):
    """``detect`` on an open contact source with the parsed detect
    options ``args`` (``chromosight_torch.cli.args.parse_args`` of a detect
    command line; ``<contact_map>`` is not read), on ``device``: one
    device or a sequence the maps go round-robin over; by default every
    visible CUDA card, the CPU only when asked (``"cpu"``).  ``rng`` is the
    ``numpy.random.RandomState`` of the ``--subsample`` draws (None: a
    fresh one).  Writes ``<prefix>.tsv`` and the windows, and returns
    (table, windows), or (None, None) when no pattern is found."""
    prefix = args["<prefix>"]
    win_fmt = args["--win-fmt"]
    _check_outputs(args)
    devices = resolve_devices(device)
    with observability.stage("scan: config"):
        cfg = scan_config(args)
    if args["--inter"]:
        sys.stderr.write(
            "WARNING: Detection on interchromosomal matrices is expensive in RAM\n"
        )
    genome, scheduler = _open_genome(
        source, args, cfg, devices, rng, dump=args["--dump"],
        smooth=bool(args["--smooth-trend"]),
    )
    device = genome.device
    with observability.stage("genome: normalize"):
        genome.normalize(args["--norm"], float(args["--n-mads"]), int(args["--threads"]))
    with observability.stage("genome: maps"):
        genome.make_sub_matrices()
    sys.stderr.write("Detecting patterns...\n")
    table, windows = _iterative_scan(genome, cfg, scheduler)
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


def _positions(chroms, pos):
    """The (chrom, pos) table ``HicGenome.coords_to_bins`` reads."""
    import pandas as pd

    return pd.DataFrame({"chrom": chroms, "pos": pos})


def _positions_for_pair(genome, bed2d, chrom1, chrom2):
    """Rows of the bed2d table on one chromosome pair whose anchor
    midpoints fall in a bin, and their (n, 2) map bins; rows outside the
    matrix are announced and dropped (reference cli:263-292)."""
    rows = np.flatnonzero((bed2d["chrom1"] == chrom1) & (bed2d["chrom2"] == chrom2))
    bins = [
        genome.coords_to_bins(
            _positions(
                bed2d[f"chrom{axis}"][rows],
                (bed2d[f"start{axis}"][rows] + bed2d[f"end{axis}"][rows]) // 2,
            )
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


def quantify(source, args, device=None, rng=None):
    """``quantify`` of the pairs of ``<bed2d>`` on an open contact source
    (``chromosight_tpu/cli/main.py:904-1090``) on ``device`` and with
    ``rng``, as for ``detect``: each pair scored with every kernel of the
    config at its anchor midpoints, the best score kept; trans pairs only
    with ``--inter``.  Writes ``<prefix>.tsv`` (rows sorted by bin, NaN
    where the window fails validation) and the windows; returns (table,
    windows)."""
    prefix = args["<prefix>"]
    _check_outputs(args)
    bed2d = read_bed2d(args["<bed2d>"])
    if not args["--inter"] and np.any(bed2d["chrom1"] != bed2d["chrom2"]):
        sys.stderr.write(
            "Warning: The bed2d file contains interchromosomal patterns. "
            "These patterns will not be scanned unless --inter is used.\n"
        )
    devices = resolve_devices(device)
    with observability.stage("scan: config"):
        cfg = _load_scan_config(
            args,
            {
                "max_perc_zero": (args["--perc-zero"], float),
                "max_perc_undetected": (args["--perc-undetected"], float),
            },
        )
    genome, scheduler = _open_genome(source, args, cfg, devices, rng)
    # scan exactly as far as the furthest requested pair
    furthest = int(np.max(bed2d["start2"] - bed2d["start1"]))
    cfg["max_dist"] = min(furthest, genome.clr.n_bins * genome.clr.binsize)
    cfg["min_dist"] = 0
    cfg["tsvd"] = TSVD_ENERGY if args["--tsvd"] else None
    with observability.stage("genome: normalize"):
        genome.normalize(args["--norm"], float(args["--n-mads"]), int(args["--threads"]))
    km, kn = cfg["kernels"][0].shape
    if args["--win-size"] != "auto":
        km = kn = _resize_config_kernels(cfg, args["--win-size"])
    genome.compute_max_dist()
    with observability.stage("genome: maps"):
        genome.make_sub_matrices()

    n_rows = len(bed2d["chrom1"])
    subs = list(genome.sub_mats.itertuples())
    pairs = [_positions_for_pair(genome, bed2d, sub.chr1, sub.chr2) for sub in subs]
    kernels = [np.asarray(k) for k in cfg["kernels"]]
    # same-shape kernels score every pair in one pass, others one by one
    passes = [kernels] if cid.fuse_kernels_eligible(kernels) else [[k] for k in kernels]
    keep = retain_maps(genome, len(passes))
    # the maps holding a pair, and each one's pairs
    items = [
        (i, sub.contact_map) for i, (sub, (rows, _)) in enumerate(zip(subs, pairs))
        if len(rows)
    ]
    coords_of = {id(sub.contact_map): coords for sub, (_, coords) in zip(subs, pairs)}
    scores, pvalues, windows = [], [], []
    for stack in passes:
        for kernel_id in range(len(scores), len(scores) + len(stack)):
            progress(kernel_id, len(kernels), f"Kernel: {kernel_id}\n")
        per_kernel = [
            (np.full(n_rows, np.nan), np.full(n_rows, np.nan),
             np.full((n_rows, km, kn), np.nan))
            for _ in stack
        ]
        results = scheduler.scan(
            items,
            lambda cm, stack=stack: cid.detect_multi(
                cm, cfg, stack, coords=coords_of[id(cm)], tsvd=cfg["tsvd"]
            ),
            keep=keep,
        )
        for (i, _), res in zip(items, results):
            rows = pairs[i][0]
            for (score, pvalue, wins), (table, w) in zip(per_kernel, res):
                if table is not None:
                    score[rows] = table["score"]
                    pvalue[rows] = table["pvalue"]
                    wins[rows] = w
        for score, pvalue, wins in per_kernel:
            scores.append(score)
            pvalues.append(pvalue)
            windows.append(wins)
    if keep:
        destroy_maps(genome)

    table, windows = _best_of_kernels(bed2d, scores, pvalues, windows)
    for axis in (1, 2):
        bins = genome.coords_to_bins(_positions(table[f"chrom{axis}"], table[f"start{axis}"]))
        # integers unless a coordinate fell outside the map (pandas' dtype)
        table[f"bin{axis}"] = bins if np.isnan(bins).any() else bins.astype(np.int64)
    table["qvalue"] = fdr_correction(table["pvalue"])
    table = {k: table[k] for k in QUANTIFY_COLUMNS}
    # coordinates whose windows failed validation keep NaN everywhere
    invalid = np.isnan(table["score"])
    table["pvalue"][invalid] = np.nan
    table["qvalue"][invalid] = np.nan
    table = _select(table, np.lexsort((table["bin2"], table["bin1"])))
    with stage("host: write", genome.device):
        write_patterns(table, prefix)
        save_windows(windows, prefix, fmt=args["--win-fmt"])
    if not args["--no-plotting"]:
        _plot_pileup(
            windows, cfg, prefix, f"pileup_of_{windows.shape[0]}_{cfg['name']}"
        )
    return table, windows


def _capture_click_windows(args, cfg, win_size, device):
    """Interactive kernel building (``chromosight_tpu/cli/main.py:
    1096-1157``): show the preprocessed map (the whole genome, or the maps
    of ``--chroms``), record the double-clicked windows and return their
    gaussian-blurred pileup."""
    import scipy.ndimage as ndi

    from chromosight_torch.plotting import _plt, click_finder

    genome = HicGenome(
        open_contacts(args["--click"]), inter=bool(args["--inter"]), kernel_config=cfg,
        device=device,
    )
    genome.normalize(args["--norm"], float(args["--n-mads"]), int(args["--threads"]))
    # scan the whole map: a distance beyond any chromosome
    genome.max_dist = genome.clr.n_bins * genome.clr.binsize
    genome.make_sub_matrices()
    half_w = int((win_size - 1) / 2)
    chroms = args["--chroms"]
    if chroms is None:
        for cm in genome.sub_mats.contact_map:
            cm.create_mat()
        windows = click_finder(genome.gather_sub_matrices().tocsr(), half_w=half_w)
    else:
        names = chroms.split(",")
        pairs = (
            itertools.combinations_with_replacement(names, 2)
            if args["--inter"]
            else [(ch, ch) for ch in names]
        )
        maps = {(sub.chr1, sub.chr2): sub.contact_map for sub in genome.sub_mats.itertuples()}
        collected = []
        for c1, c2 in pairs:
            if (c1, c2) not in maps:
                c1, c2 = c2, c1
            cm = maps[(c1, c2)]
            cm.create_mat()
            collected.append(click_finder(cm.matrix.tocsr(), half_w=half_w, xlab=c2, ylab=c1))
            cm.destroy_mat()
        windows = np.concatenate(collected, axis=0)

    pileup = ndi.gaussian_filter(cid.pileup_patterns(windows), 1)
    plt = _plt()
    hm = plt.imshow(np.log(pileup), vmax=np.percentile(pileup, 99), cmap="afmhot_r")
    plt.colorbar(hm).set_label("Log10 Hi-C contacts")
    plt.title("Manually generated kernel")
    plt.show()
    return pileup


def _json_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"not JSON serializable: {type(obj)}")


def cmd_detect(args, device=None, rng=None):
    """``detect`` with the parsed options ``args``, its map opened from
    ``<contact_map>`` (the JAX package's ``cmd_detect``); ``device`` and
    ``rng`` as for ``detect``."""
    with observability.stage("genome: open"):
        source = open_contacts(args["<contact_map>"])
    return detect(source, args, device, rng)


def cmd_quantify(args, device=None, rng=None):
    """``quantify`` with the parsed options ``args``, its map opened from
    ``<contact_map>`` (the JAX package's ``cmd_quantify``)."""
    with observability.stage("genome: open"):
        source = open_contacts(args["<contact_map>"])
    return quantify(source, args, device, rng)


def cmd_generate_config(args, device=None):
    """Write a preset (or, with ``--click``, an interactively captured)
    kernel config: ``<prefix>.json`` and one ``<prefix>.N.txt`` per kernel,
    byte for byte what ``chromosight_tpu/cli/main.py:cmd_generate_config``
    writes.  Only ``--click`` reads a map, on ``device``."""
    prefix = args["<prefix>"]
    cfg = load_kernel_config(args["--preset"], False)
    check_prefix_dir(prefix)
    if args["--win-size"] != "auto":
        win_size = _resize_config_kernels(cfg, args["--win-size"])
    else:
        win_size = cfg["kernels"][0].shape[0]
    if args["--click"]:
        cfg["kernels"] = [_capture_click_windows(args, cfg, win_size, device).tolist()]
    for mat_id, mat in enumerate(cfg["kernels"]):
        mat_path = f"{prefix}.{mat_id + 1}.txt"
        np.savetxt(mat_path, mat)
        cfg["kernels"][mat_id] = mat_path
    with open(f"{prefix}.json", "w") as config_handle:
        json.dump(cfg, config_handle, indent=4, default=_json_default)


def cmd_list_kernels(args):
    """Print the presets (``chromosight_tpu/cli/main.py:cmd_list_kernels``):
    names, with ``--long`` their parameters, with ``--mat`` their kernels
    as ASCII art."""
    from chromosight_torch.plotting import print_ascii_mat

    available = kernel_names
    kernel_name = args["--name"]
    for k in available if kernel_name == "all" else [kernel_name]:
        if k not in available:
            raise ValueError(f"Kernel {k} is not available")
        kernel_infos = load_kernel_config(k, False)
        print(k)
        if args["--long"]:
            for param, value in kernel_infos.items():
                if param not in ("name", "resolution", "kernels"):
                    print(f"  {param}: {value}")
        if args["--mat"]:
            for mat in kernel_infos["kernels"]:
                print_ascii_mat(mat)


def example_dataset():
    """The self-test's fallback map, ``LOCAL_EXAMPLE_DATASET``: by default
    ``data_test/example.cool``, read with the port's own HDF5 reader on
    every machine."""
    return LOCAL_EXAMPLE_DATASET


def cmd_test(args, device=None):
    """Self-test (``chromosight_tpu/cli/main.py:cmd_test``): loop
    detection on the example map, downloaded or, when the download fails,
    the repository's copy (``example_dataset``), on ``device``; writes
    ``chromosight_test.tsv`` and ``.json`` in the working directory."""
    sys.stderr.write(f"Fetching test dataset at {URL_EXAMPLE_DATASET}...\n")
    tmp_cool = tempfile.NamedTemporaryFile(delete=False)
    tmp_cool.close()
    try:
        try:
            download_file(URL_EXAMPLE_DATASET, tmp_cool.name)
            path = tmp_cool.name
        except (OSError, http.client.HTTPException):
            path = example_dataset()
        sys.stderr.write("Running detection on test dataset...\n")
        args["<contact_map>"] = path
        args["<prefix>"] = "chromosight_test"
        args["--no-plotting"] = True
        detect(open_contacts(path), args, device)
    finally:
        os.unlink(tmp_cool.name)


@contextmanager
def capture_output(stderr_to=None):
    """Capture stderr during the self-test run."""
    try:
        stderr = sys.stderr
        sys.stderr = c2 = stderr_to or io.StringIO()
        yield c2
    finally:
        sys.stderr = stderr
        try:
            c2.flush()
            c2.seek(0)
        except (ValueError, IOError):
            pass


def logo_version(logo, ver):
    """The ``--version`` text: ``logo`` (``LOGO``) as ASCII art, then the
    version."""
    from chromosight_torch.plotting import print_ascii_mat

    small_logo = resize_kernel(logo, factor=0.33, quiet=True)
    ascii_logo = print_ascii_mat(small_logo, colored=False, print_str=False)
    return f"{ascii_logo} chromosight-torch version {ver}"


def _run_self_test(args, device=None):
    """Run ``test`` and compare the lines of its log with ``TEST_LOG``."""
    with capture_output() as stderr:
        cmd_test(args, device)
    obs_log = stderr.read()
    sys.stderr.write(obs_log)
    obs_log_lines = {
        u.strip("\x1b[K") for u in set(obs_log.split("\n")) if "\r" not in u
    }
    exp_log_lines = set(TEST_LOG.split("\n"))
    if len(exp_log_lines ^ obs_log_lines):
        sys.stderr.write(
            "\nWarning, the test log differed from the "
            "expected one. This means the program changed its output from"
            "previous versions. You may ignore this if you are not a "
            "developer.\n\n"
            f"Here is the expected log:\n\n{TEST_LOG}\n"
        )


def main(argv=None, device=None, rng=None):
    """Command-line entry point.  ``device``: one ``torch.device`` or name,
    or a sequence of them; by default every visible CUDA card, and a
    raise without one: the CPU is used only when the caller asks for it
    (``device="cpu"``).  ``rng``: the ``numpy.random.RandomState`` of
    ``--subsample`` (None: a fresh one).  ``list-kernels`` and
    ``generate-config`` without ``--click`` use no device."""
    if argv is None:
        argv = sys.argv[1:]
    version = logo_version(LOGO, __version__) if "--version" in argv else None
    try:
        args = parse_args(argv, __doc__, version=version)
    except CliError as exc:
        return exc.code
    # a torch.profiler trace of the whole command with
    # CHROMOSIGHT_TPU_PROFILE=<dir>; ``command`` is the root of its spans
    with observability.maybe_trace(), observability.stage("command"):
        if args["test"]:
            _run_self_test(args, device)
        elif args["detect"]:
            cmd_detect(args, device, rng)
        elif args["generate-config"]:
            cmd_generate_config(args, device)
        elif args["list-kernels"]:
            cmd_list_kernels(args)
        elif args["quantify"]:
            cmd_quantify(args, device, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
