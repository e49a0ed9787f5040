#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (chromosight_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py            # all phases; last line is the result
    python3 chip_smoke.py --quick    # env, build and small kernel checks only

Phases, one line or block each; any failure raises (non-zero exit):

1. env      torch and CUDA versions, nvidia-smi's driver_version, the card,
            optional packages, the host's CPU model and core count;
2. build    nvcc build of chromosight_torch/csrc/*.cu for sm_90a: registers
            and spills of every instance (ptxas), and the dynamic shared
            memory of the chr1 and centromeres launches;
3. kernels  the CUDA band Pearson against its plain PyTorch twin on the
            card (corr within 1e-6, log10 p within 1e-5 or two float32
            ulps), in single-kernel mode (random bands of tests/test_pallas.py
            shapes, the 81x81 centromeres kernel, the --tsvd taps of the
            loops kernel) and in K-kernel mode (the three borders kernels,
            nine 5x9 kernels split over two launches), each K-kernel launch
            bit-identical to K single launches, launches on two streams
            at once equal to launches on one, and the three fp32 decision
            boundaries of tests/test_fp32_boundaries.py (the min_pres cutoff,
            the 1e-10 guard, the pearson straddle) against their float64
            oracle; then chr1 of the synthetic
            genome, loops and borders, with device times (CUDA events) of
            one fused launch, K single launches and the plain twins, and the
            kernel-only time (torch.profiler) beside the float64 bound of
            these inputs and its share;
4. golden   ``detect`` on data_test/example.cool (read by the port's own
            HDF5 reader, chromosight_torch/io/hdf5.py) reproduces
            tests/data/golden_detect_loops{,_raw,_smooth,_tsvd}.tsv and
            golden_detect_borders.tsv (fused), the loops windows against
            tests/data/golden_detect_loops.json, the ``--dump`` snapshots of
            tests/data/golden_dump/; the loops golden again from the
            cooler-layout fixture tests/data/example_cooler_layout.cool
            (chunked, gzip, shuffle, an enum); and ``quantify`` of
            data_test/example.bed2 reproduces golden_quantify_loops.tsv and
            golden_quantify_borders.tsv;
4b. formats the same goldens from HDF5's newer formats, read by the
            port's reader: tests/data/example_latest.cool (libver "latest":
            superblock 3, dense attributes, extensible- and fixed-array
            chunk indexes) and example_latest.mcool::/resolutions/1000
            (libver "v110", dense links, LZF): the seconds of each file's
            open, index walk and read and the structures walked, ``detect``
            loops and borders and ``quantify`` loops from the .cool and
            loops from the .mcool, each table byte for byte the one from
            data_test/example.cool and the band kernel launched on every
            map; ``--norm force`` on a copy of the .cool with its weights
            dropped (``File.unlink``) stores the weights that ``--norm
            force`` stores into a copy of example.cool, bit for bit, and
            gives its table byte for byte; then the example through one
            HDF5 feature each (tests/data/example_{soft,scaleoffset,nbit,
            external_storage,shared,dense_bins,szip,szip_shuffle_ec,
            virtual,virtual_printf}.cool and example_external.mcool, written by
            tests/test_torch_hdf5_features.py): the feature's structure
            walked, loops, borders and quantify byte for byte the tables
            from example.cool, ``--norm force`` on a copy storing its 637
            weights bit for bit (a fixture missing fails the phase);
5. genome   on a synthetic 13 x 48,000-bin genome at 5 kb (the bench.py
            shape): ``detect`` with loops (recall of the planted loops) and
            with borders (13 fused launches), and ``quantify`` of the planted
            loops written as a bed2d file, scores held against the sweep
            kernel's; walls, stages, launches and peak device memory; each
            chromosome's band upload (the count path: its mode, u4, u8 or
            u16, its exceptions and bytes; the run fails if one took the
            float32 band); then the three runs again with
            ``contact_map.COUNT_PACKING = None`` (the float32 band scattered
            and balanced on the host): tables and windows byte for byte,
            ``io: fetch+scatter``, ``io: upload`` and walls side by side;
            and chr1's preprocessed band through u4, u8, u16 and the f32
            path, balanced and raw, bit for bit;
6. golden-inter  ``detect --inter`` on data_test/example.cool
            reproduces tests/data/golden_detect_loops_inter.tsv on the dense
            engine and, with ``DENSE_LIMIT`` lowered to 50, on the tiled
            engine (tiles of 128); ``quantify --inter`` of the four pairs of
            tests/test_golden_outputs.py gives the same rows on both;
7. genome-inter  a synthetic 3 x 50,000-bin genome at 5 kb with trans
            contacts at 1e-3 of the cells: ``detect --inter`` with loops
            (recall, trans calls, tiles scanned and skipped, walls, stages,
            launches, peak device memory held below one dense trans map);
            the trans fetch of each pair through the native
            ``trans_coo_balanced`` against its numpy fallback (the same
            triplets, seconds of both); then an 8,192 x 8,192 cut of a
            trans map through the dense and the tiled engines: the same
            corr, foci and calls (the 10% zero rule lifted for the calls);
8. surface  the rest of the command line: ``test`` (offline: the download
            is replaced by a failure, so it reads data_test/example.cool; 89
            patterns and the golden log lines), ``list-kernels --long
            --mat`` (seven presets), ``generate-config --preset borders``
            then ``detect --kernel-config`` of the file (the borders
            golden), ``--norm force`` on a copy of example.cool (calls as
            the port's own CPU run's; the copy reopened holds the CPU run's
            weights bit for bit, and ``--norm auto`` of it gives the forced
            run's table byte for byte); on the 13 x 48,000 genome with its
            weights dropped,
            ``detect`` at ``--norm auto`` (ICE on the host, the table byte
            for byte phase 5's), ``--threads`` 1, 2 and 4 and two workers
            on the one card (tables byte for byte the serial one's; walls,
            stages, launches, peak memory); ``--subsample 0.5`` on its
            first three chromosomes (the 10% zero rule lifted: half the
            contacts leave most windows of this map over 10% zeros),
            ``--threads 4`` against ``--threads 1`` with one seed; and the
            native float32 band scatter and count scatter of the genome, on
            the main thread and on a thread of its own.  It runs after
            phase 5, on the same genome.
8b. cool-genome  phase 5's genome written as a ``.cool`` (3.8 GB) by the
            port's ``create_cool`` (the free space checked first), then
            ``detect`` with loops from the file (its pages dropped from the
            page cache first, then again from the cache, then through the
            float32 band), ``quantify`` of the planted loops from it, and
            ``detect`` once more from memory: tables and windows byte for
            byte phase 5's, the bytes read from each pixel column (the
            count path never reads bin1_id), ``io: fetch+scatter``, ``io:
            upload`` and walls side by side; the file is the bench's cached
            genome (``chromosight_torch.bench.genome``), kept for 8g;
8g. bench   ``python3 bench_torch.py`` in a process of its own on 8b's
            file (the user's genome detect bench, ``--threads 4``): one
            stdout line with bench.py's contract keys and ``device``,
            ``peak_memory_bytes`` and ``idle_share``, the card's name and
            power limit, recall >= 0.95, 13 band launches a timed pass, its
            table byte for byte 8b's; its wall, rate, baseline, link,
            stages and idle share printed; then the quantify bench
            (``chromosight_torch.bench.quantify``): 624 coordinates, scored
            as in phase 5; the file deleted.
8c. cooler-genome  phase 5's genome (not cut) written by the port in
            cooler's own layout as ``genome.mcool::/resolutions/5000`` (int64
            ids, int32 counts, every dataset chunked, 6,094 / 12,188 rows a
            pixel chunk, shuffle + gzip 6, an enum ``bins/chrom``; the free
            space checked first): the write's seconds, the file's size and
            each pixel column's chunk B-tree depth (2 for bin2_id's 52,084
            chunks); ``detect`` loops and ``quantify`` from it, pages
            dropped and from the page cache: tables and windows byte for
            byte phase 5's, 13 single launches for loops, ``io:
            fetch+scatter``, ``io: upload``, walls and bytes read per column
            beside the contiguous ``.cool``'s runs of 8b; the file deleted.
8d. latest-genome  phase 5's genome (not cut) written by the port
            without weights in HDF5's newest layout (superblock 3,
            extensible-array pixel columns, int64 ids, shuffle + gzip 6, an
            enum ``bins/chrom``) with five more bins columns (KR, VC,
            VC_SQRT, GW_KR, GW_VC: 8 links): the write's seconds and size;
            (a) ``detect`` loops at ``--norm auto``, ICE on the host storing
            the weights (the ninth link turns bins dense), (b) loops again
            from the stored weights, (c) ``--norm force`` replacing the
            weight link in the dense group, (d) ``quantify`` of the planted
            loops: weights bit for bit the genome's, tables and windows
            byte for byte phase 5's, 13 single launches a loops run, the
            structures walked, stages beside 8c's; the file deleted.
8e. userblock-genome  phase 5's genome (not cut) written by the port
            without weights in cooler's layout (superblock 0, int64 ids,
            shuffle + gzip 6) after a 512-byte user block holding a text
            header, with 4-byte offsets and lengths: the write's seconds and
            size; through ``cmd_detect`` / ``cmd_quantify``, (a) loops at
            ``--norm auto`` (ICE storing the weights into the file), (b)
            loops again, (c) ``--norm force``, (d) quantify: weights bit for
            bit the genome's, tables and windows byte for byte phase 5's, 13
            single launches a loops run, the user block unchanged; ICE,
            ``io: fetch+scatter`` and the wall of each run beside 8d's; the
            file deleted.
8f. szip-genome  phase 5's genome (not cut) written by the port in
            cooler's layout with szip (``write_cooler_layout(...,
            compression="szip")``: shuffle + szip ('nn', 8) on every
            column HDF5 takes szip for, int64 ids, an enum ``bins/chrom``;
            the free space checked first) as
            ``genome.mcool::/resolutions/5000``: the write's seconds and
            bytes; ``detect`` loops with its pages dropped and from the
            page cache, and ``quantify`` of the planted loops: tables and
            windows byte for byte phase 5's, 13 single launches a loops
            run, szip chunks walked, ``io: fetch+scatter``, ``io: upload``
            and the wall beside 8c's runs of the same call; the file
            deleted.
9. api      the Python API of docs/TUTORIAL.md and the notebooks, on the
            card by default: TUTORIAL's block and detect_example.ipynb's loop
            on the example map (each map's calls those of the command line's
            per-map path), quantify_api.ipynb's flow (as on the CPU); the
            notebook loop over the 13 x 48,000 genome with kernels.loops
            (13 launches, calls identical to detect_multi's, the wall beside
            phase 5's); ``full=False`` on the example's maps and on the
            genome's chr1 (48,000 bins, not cut) against the CPU's run.
10. genome-golden  the reference's own genome-scale calls
            (tests/data/golden_genome_{loops,borders}.tsv: 159 and 3,706) on
            the seed-0 3 x 50,000 genome, its fingerprint checked, written as
            a ``.cool`` by the port's ``create_cool`` and read back: the same
            calls, score max|d| < 5e-5, log10 p max|d| < 1e-3 from the
            unrounded p-values, and the log10 p max|d| between the written
            tables printed; the file is written under the bench's cache
            name, for phase 12 (as is phase 7's genome);
11. instruments  chromosight_torch.observability on the loops run of
            phase 5's genome (it runs after phase 5): compute accounting per
            program family, link bytes, device_peaks(), FLOP/s per family
            over its stage; 13 band dispatches, uploads equal to the packed
            bands' bytes (reckoned from each map's mode and exceptions, the
            float32 bands' bytes beside them), downloads; a CHROMOSIGHT_TPU_PROFILE trace of one
            chromosome naming the band kernel, and of the genome's detect
            passes (the card's busy and idle share, device time by
            kernel); the exit report of a command-line process with
            CHROMOSIGHT_TPU_TIMINGS=1.
12. baseline-configs  the eight BASELINE rows through
            ``chromosight_torch.bench.baseline_configs``: rows 1, 2, 3 and 5b
            on data_test/example.cool, row 4 (``-n force -m 50000 -M
            1000000`` on a copy), 5 (``--tsvd``) and 5c (``-I``) on phase
            10's and phase 7's genomes from their files: every row ``ok``
            with the JAX package's pattern counts (85, 53, 57, 55, 68, 159,
            90), row 5c with 159, the reference's own calls of
            tests/data/golden_genome_loops.tsv (the JAX record says 157:
            ROADMAP.md §3), walls printed; then the ``--inter`` bench
            (``chromosight_torch.bench.inter``) on row 5c's file, two reps
            with row 5c's calls.

It prints the kernel table and the card's ``nvidia-smi`` name and power
limit, then ``{"ok": true, "device": {...}}`` as its last line, after
checking that neither jax nor h5py was imported.  Without a
CUDA card, or outside the repository, it exits non-zero and prints no
result.
"""

import argparse
import builtins
import contextlib
import copy
import csv
import ctypes
import hashlib
import io
import json
import os
import pathlib
import platform
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")

import chromosight_torch.cli.main as cli  # noqa: E402
import chromosight_torch.native as host_native  # noqa: E402
import chromosight_torch.observability as observability  # noqa: E402
import chromosight_torch.ops.band_pearson as bp  # noqa: E402
import chromosight_torch.ops.tiled as tiled  # noqa: E402
import chromosight_torch.runtime.contact_map as contact_map  # noqa: E402
from chromosight_torch.bench import baseline_configs as bench_rows  # noqa: E402
from chromosight_torch.bench import genome as bench_genome  # noqa: E402
from chromosight_torch.bench import inter as bench_inter  # noqa: E402
from chromosight_torch.bench import quantify as bench_quantify  # noqa: E402
from chromosight_torch.bench.detect import device_busy  # noqa: E402
from chromosight_torch.cli.main import detect, main, parse_args, quantify  # noqa: E402
from chromosight_torch.detection import (  # noqa: E402
    detect_multi,
    frame_contact_map,
    pattern_detector,
    pick_foci,
    quantify_banded,
)
from chromosight_torch.device import reset_stages, stage_seconds  # noqa: E402
from chromosight_torch.io import hdf5  # noqa: E402
from chromosight_torch.io.config import load_kernel_config  # noqa: E402
from chromosight_torch.io.cool import (  # noqa: E402
    CoolFile,
    bins_frame,
    write_cooler_layout,
)
from chromosight_torch.io.source import (  # noqa: E402
    ArraySource,
    native_scatter_available,
    planted_recall,
)
from chromosight_torch.ops import _build  # noqa: E402
from chromosight_torch.ops.band import (  # noqa: E402
    band_frame,
    pearson_reference,
    pearson_reference_multi,
    shear_kernel,
)
from chromosight_torch.ops.normxcorr import (  # noqa: E402
    make_missing_mask_dense,
    normxcorr2_dense,
)
from chromosight_torch.ops.tiled import normxcorr2_sparse_tiled  # noqa: E402
from chromosight_torch.preprocessing import missing_flags  # noqa: E402
from chromosight_torch.runtime.contact_map import ContactMap  # noqa: E402
from chromosight_torch.runtime.genome import HicGenome, open_contacts  # noqa: E402

GENOME_CHROMS, GENOME_BINS, BINSIZE = 13, 48_000, 5000
# --subsample permutes ~1.5e8 contacts per chromosome on the host: three
# of the genome's chromosomes (a cut of depth, not of width)
SUBSAMPLE_CHROMS = 3
MISSING_TOL, PEARSON = 0.5, 0.3
TSVD = 0.999
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
DEVICE = torch.device("cuda")
# genome-inter: the config-5c shape (three 50,000-bin chromosomes) with
# trans contacts at 1e-3 of the cells, and the cut both engines scan
INTER_CHROMS, INTER_BINS, TRANS_DENSITY = 3, 50_000, 1e-3
INTER_CUT = 8192
# the quantify --inter pairs of tests/test_golden_outputs.py:207-210
INTER_PAIRS = (
    "chr1\t63000\t64000\tchr1\t74000\t75000\n"
    "chr1\t50000\t51000\tchr2\t80000\t81000\n"
    "chr1\t100000\t101000\tchr2\t200000\t201000\n"
    "chr2\t130000\t131000\tchr3\t139000\t140000\n"
)
ERRS = {"single": [], "multi": []}  # corr max|d| against the plain twins
UPLOADS_SHOWN = set()  # the band-uploads lines printed
# walls (s) and stage seconds of the main-path runs, by name
WALLS, STAGES = {}, {}
EXAMPLE_COOL = "data_test/example.cool"
# data_test/example.cool's data in cooler's layout (chunked, gzip 6,
# shuffle, bins/chrom an enum): tests/test_torch_hdf5.py writes it
COOLER_LAYOUT = "tests/data/example_cooler_layout.cool"
# the same data in HDF5's newer formats (tests/test_torch_hdf5_formats.py
# writes them): libver "latest", and a libver "v110" .mcool with LZF
LATEST_COOL = "tests/data/example_latest.cool"
LATEST_MCOOL = "tests/data/example_latest.mcool"
# the example through one HDF5 feature each (tests/test_torch_hdf5_features.py
# writes them): (feature, URI, the files it reads besides, what the reader
# must walk)
FEATURE_FIXTURES = (
    ("soft links", "tests/data/example_soft.cool", (), "soft link"),
    ("external link", "tests/data/example_external.mcool::/resolutions/1000",
     (LATEST_COOL,), "external file"),
    ("scale-offset", "tests/data/example_scaleoffset.cool", (), "scale-offset chunk"),
    ("n-bit", "tests/data/example_nbit.cool", (), "n-bit chunk"),
    ("external storage", "tests/data/example_external_storage.cool",
     ("tests/data/example_external_storage.raw",), "external storage"),
    ("shared messages", "tests/data/example_shared.cool", (), "shared message in a heap"),
    ("dense bins", "tests/data/example_dense_bins.cool", (), "BTHD type 5"),
    ("szip NN", "tests/data/example_szip.cool", (), "szip chunk"),
    ("shuffle + szip EC", "tests/data/example_szip_shuffle_ec.cool", (), "szip chunk"),
    ("virtual", "tests/data/example_virtual.cool",
     ("tests/data/example_virtual_a.h5", "tests/data/example_virtual_b.h5"), "virtual mapping"),
    ("virtual %b", "tests/data/example_virtual_printf.cool",
     tuple(f"tests/data/example_virtual_printf_{k}.h5" for k in range(3)), "virtual mapping"),
)
# latest-genome: more bins columns, named as normalisation vectors are
# (with chrom, start and end, the eight links of a compact group)
NORM_COLUMNS = ("KR", "VC", "VC_SQRT", "GW_KR", "GW_VC")
# genome-golden: the genome of tests/data/golden_genome_meta.json
GOLDEN_CHROMS, GOLDEN_BINS = 3, 50_000
# the windows of tests/test_fp32_boundaries.py
FP32_N, FP32_WIDTH, FP32_MAX_DIST = 512, 128, 100
COUNT_MODES = ("u4", "u8", "u16")
# cooler-genome: cooler creates its pixel columns resizable at an estimate
# of their length and h5py picks their chunks from it; at 5 x 624,000 rows
# the chunks hold 6,094 int64 or 12,188 int32 rows
COOLER_PIXEL_ROWS = 5 * 624_000


# the script's own lines go to the standard output; run() sends what the
# port prints there (progress, "Found ... detectable bins") to stderr
RESULTS = sys.stdout


def print(*args, **kwargs):
    kwargs.setdefault("file", RESULTS)
    kwargs.setdefault("flush", True)
    builtins.print(*args, **kwargs)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi(query):
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def reset_launches():
    bp.LAUNCHES = 0
    bp.LAUNCHES_MULTI = 0


class Launches(dict):
    """Launch counts by mode ({"single": n, "multi": m}), printed short."""

    def __repr__(self):
        return f"{self['single']} single + {self['multi']} multi"

    __str__ = __repr__


def launches():
    return Launches(single=bp.LAUNCHES, multi=bp.LAUNCHES_MULTI)


@contextlib.contextmanager
def packing(mode):
    """Band maps made inside the block ship their counts in ``mode``
    (``contact_map.COUNT_PACKING``: "u4", "u8", "u16"; None: the float32
    band); the default is restored after it."""
    old = contact_map.COUNT_PACKING
    contact_map.COUNT_PACKING = mode
    try:
        yield
    finally:
        contact_map.COUNT_PACKING = old


def packed_bytes(record):
    """The bytes a balanced band map's upload ships, reckoned from its
    ``observability.band_uploads()`` record: the packed arrays, 8 bytes per
    exception (int32 index, float32 value) and the rows' float64
    weights; or the float32 band."""
    (n, width), mode = record["shape"], record["mode"]
    extra = 8 * record["exceptions"] + 8 * n
    if mode == "u4":
        head = contact_map.U4_HEAD
        return n * head + n * ((width - head + 1) // 2) + extra
    if mode == "u8":
        return n * width + extra
    if mode == "u16":
        return 2 * n * width + extra
    return 4 * n * width


def band_uploads(source, tag, modes=COUNT_MODES):
    """Each of the genome's chromosomes' band upload in the last run
    (``observability.band_uploads()``: mode, exceptions, bytes), printed;
    fails unless every one took one of ``modes``.  Returns the bytes
    they shipped."""
    uploads = observability.band_uploads()
    records = [uploads[f"{c}-{c}"] for c in source.chromnames]
    taken = {}
    for r in records:
        taken[r["mode"]] = taken.get(r["mode"], 0) + 1
    exceptions = [r["exceptions"] for r in records]
    total = sum(packed_bytes(r) for r in records)
    line = (", ".join(f"{n} {m}" for m, n in sorted(taken.items()))
            + f"; exceptions {min(exceptions)}-{max(exceptions)} a map; {total} bytes")
    if line not in UPLOADS_SHOWN and modes != ("f32",):
        # a run whose uploads repeat ones already shown prints nothing
        # more; the float32 bands' bytes are in the instruments line
        print(f"[{tag}] band uploads: {line}")
        UPLOADS_SHOWN.add(line)
    left = [c for c, r in zip(source.chromnames, records) if r["mode"] not in modes]
    check(not left, f"{tag}: {left} did not take {modes}")
    return total


def outputs(prefix):
    """{file name suffix: bytes} of the files a run wrote at ``prefix``."""
    path = pathlib.Path(prefix)
    return {p.name[len(path.name):]: p.read_bytes()
            for p in path.parent.glob(path.name + ".*")}


@contextlib.contextmanager
def counting_reads(totals):
    """Bytes that the port's HDF5 reader returns inside the block, added
    to ``totals`` by dataset ("pixels/count", ...)."""
    getitem = hdf5.Dataset.__getitem__

    def counted(self, key):
        out = getitem(self, key)
        name = "/".join(self.name.rstrip("/").rsplit("/", 2)[-2:])
        totals[name] = totals.get(name, 0) + out.nbytes
        return out

    hdf5.Dataset.__getitem__ = counted
    try:
        yield totals
    finally:
        hdf5.Dataset.__getitem__ = getitem


def host_cpu():
    """The host's CPU as /proc/cpuinfo names it: model name, vendor,
    family and model number (a virtual machine may hide the name)."""
    info = {}
    with open("/proc/cpuinfo") as handle:
        for line in handle:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name', platform.processor() or 'unknown')} "
            f"({info.get('vendor_id', '?')} family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')}, {platform.machine()})")


def phase_env():
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} driver_version {nvidia_smi('driver_version')}")
    print(f"[env] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    imports = {}
    for name in ("triton", "h5py", "pandas", "jsonschema", "scipy", "jax"):
        res = subprocess.run([sys.executable, "-c", f"import {name}"],
                             capture_output=True, timeout=120)
        imports[name] = res.returncode == 0
    print(f"[env] imports: {json.dumps(imports)}")
    print(f"[env] host native scatter (g++): {native_scatter_available()}; HDF5 filters "
          f"native: {host_native.filters_native()}; host CPU {host_cpu()}, {os.cpu_count()} "
          f"cores")
    print(nvidia_smi("name,power.limit"))


def phase_build():
    _build.load()
    info = _build.BUILD_INFO
    print(f"[build] {os.path.relpath(info['path'])} in {info['seconds']:.2f} s")
    # ptxas per instance (side x side, or "any" shape / diagonals per
    # thread): registers, stack frame bytes, spill stores / loads bytes
    instances, name, entry, own = {}, None, None, False
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            entry, own = line.split("'")[1], True
            inst = re.search(r"band_pearson_tiledILi(\d+)ELi(\d+)E", line)
            name = (f"{'any' if inst.group(1) == '0' else inst.group(1)}/{inst.group(2)}"
                    if inst else "?")
            instances[name] = {}
        elif "Function properties for" in line:
            # the outlined epilogue functions report their own frames
            own = entry is not None and line.rstrip().endswith(entry)
        elif name is not None and ("registers" in line or ("spill" in line and own)):
            for key, pattern in (("regs", r"Used (\d+) registers"),
                                 ("stack", r"(\d+) bytes stack frame"),
                                 ("spills", r"(\d+ bytes spill stores, \d+) bytes spill loads")):
                found = re.search(pattern, line)
                if found:
                    instances[name][key] = found.group(1).replace(" bytes spill stores, ", "/")
    print("[build] ptxas, side/diagonals per thread: registers, stack frame bytes, spill "
          "stores/loads bytes: " + "; ".join(
              f"{n} {v.get('regs', '?')} {v.get('stack', '?')} {v.get('spills', '?')}"
              for n, v in instances.items()))
    lib = _build.load()
    lib.band_pearson_smem_bytes.restype = ctypes.c_longlong
    print("[build] dynamic shared memory per block (bytes), side K at diagonals: " + ", ".join(
        f"{side}x{side} K={k} at {w_out}: {lib.band_pearson_smem_bytes(side, side, k, w_out)}"
        for side, k, w_out in ((17, 1, 418), (17, 3, 418), (17, 3, 19), (81, 1, 122))))


def compare(name, ref, got, n, max_dist, pearson=PEARSON):
    """Kernel output ``got`` against the plain twin ``ref`` (both on the
    card; both sum in float64, in different orders, and round corr and
    log10 p to float32 once): corr within 1e-6, log10-p within 1e-5 (or
    two float32 ulps of the twin's value, 1.5e-5 at a log10 p of -134)
    and equal finiteness on valid pixels, candidate flips only within
    1e-6 of the threshold."""
    corr_r, logp_r, cand_r = (t.cpu().numpy() for t in ref)
    corr_g, logp_g, cand_g = (t.cpu().numpy() for t in got)
    check(corr_r.shape == corr_g.shape, f"{name}: shapes differ")
    corr_err = float(np.abs(corr_r - corr_g).max())
    flips = cand_r != cand_g
    flip_gap = float(np.abs(corr_r[flips] - pearson).max()) if flips.any() else 0.0
    oi, od = np.indices(corr_r.shape)
    valid = (od <= max_dist) & (oi < n) & (oi + od < n)
    a, b = logp_r[valid], logp_g[valid]
    same_kind = np.array_equal(np.isfinite(a), np.isfinite(b)) and np.array_equal(
        np.isnan(a), np.isnan(b)
    )
    both = np.isfinite(a) & np.isfinite(b)
    d_logp = np.abs(a[both] - b[both])
    logp_err = float(d_logp.max(initial=0.0))
    ulps = float((d_logp / np.spacing(np.abs(a[both]))).max(initial=0.0))
    logp_ok = bool(np.all(d_logp <= np.maximum(1e-5, 2 * np.spacing(np.abs(a[both])))))
    check(corr_err <= 1e-6, f"{name}: corr differs by {corr_err}")
    check(same_kind, f"{name}: log10p finiteness differs")
    check(logp_ok, f"{name}: log10p differs by {logp_err}")
    check(flip_gap <= 1e-6, f"{name}: candidate flip {flip_gap} from the threshold")
    return {"corr": corr_err, "logp": logp_err, "ulps": ulps, "flips": int(flips.sum()),
            "gap": flip_gap, "cand": int(cand_r.sum())}


REPORTS = []  # the kernel-against-twin results of a phase, printed by flush_reports
COLUMNS_SHOWN = []  # whether flush_reports named its columns yet


def report(name, results):
    """Keep, for one line of ``flush_reports``, the kernel-against-twin
    comparisons ``results`` (one per kernel of a launch): the largest
    differences and the candidate counts."""
    worst = {key: max(r[key] for r in results) for key in ("corr", "logp", "ulps", "gap")}
    REPORTS.append(f"{name} {worst['corr']:.3g} {worst['logp']:.3g} {worst['ulps']:.0f} "
                   f"{sum(r['flips'] for r in results)} {worst['gap']:.2g} "
                   + "/".join(str(r["cand"]) for r in results))


def flush_reports(what):
    """One line of the kept comparisons: per case, corr max|d|, log10 p
    max|d|, its float32 ulps, candidate flips, their largest gap to the
    threshold, candidates (per kernel of a K-kernel launch, each slice
    bit-identical to its single launch)."""
    columns = ("columns as above" if COLUMNS_SHOWN else
               "corr max|d|, log10p max|d|, ulps, cand flips, max gap, candidates")
    print(f"[kernels] {what} against the plain twin ({columns}): " + "; ".join(REPORTS))
    REPORTS.clear()
    COLUMNS_SHOWN.append(True)


def random_case(kernel_shape, n, n_pad, rng):
    """A tests/test_pallas.py band (40% filled, rows 3, 77, 200 missing),
    framed on the card: (sig_p, mask_p, max_dist)."""
    mk, nk = kernel_shape
    max_dist = 40
    width = max_dist + max(mk, nk) + 1
    band = (rng.rand(n_pad, width) * (rng.rand(n_pad, width) < 0.4)).astype(np.float32)
    band[n:] = 0
    miss = np.zeros(n_pad, bool)
    miss[[3, 77, 200]] = True
    band[miss] = 0
    sig_p, mask_p = band_frame(
        torch.from_numpy(band).to(DEVICE), torch.from_numpy(miss).to(DEVICE),
        kernel_shape, n, max_dist,
    )
    return sig_p, mask_p, max_dist


def run_both(name, sig_p, mask_p, kernel, n, max_dist, pearson=PEARSON, tsvd=None):
    """Single-kernel launch and plain twin on the same framed inputs."""
    args = (kernel, n, max_dist, MISSING_TOL, pearson)
    got = bp.band_pearson(sig_p, mask_p, *args, tsvd=tsvd)
    ref = pearson_reference(sig_p, mask_p, *args, tsvd=tsvd)
    torch.cuda.synchronize()
    result = compare(name, ref, got, n, max_dist, pearson)
    ERRS["single"].append(result["corr"])
    report(name, [result])


def run_multi(name, sig_p, mask_p, kernels, n, max_dist, pearson=PEARSON):
    """K-kernel launch against K single launches (bit for bit on every
    output, NaN included) and against the plain K-kernel twin."""
    args = (n, max_dist, MISSING_TOL, pearson)
    got = bp.band_pearson(sig_p, mask_p, kernels, *args)
    singles = [bp.band_pearson(sig_p, mask_p, k, *args) for k in kernels]
    ref = pearson_reference_multi(sig_p, mask_p, kernels, *args)
    torch.cuda.synchronize()
    results = []
    for k, single in enumerate(singles):
        for out, one in zip(got, single):
            check(torch.equal(out[k].view(torch.uint8), one.view(torch.uint8)),
                  f"{name}: K-kernel slice {k} differs from its single launch")
        results.append(compare(
            f"{name} k={k}", [r[k] for r in ref], [g[k] for g in got], n, max_dist,
            pearson,
        ))
        ERRS["multi"].append(results[-1]["corr"])
    report(f"{name} K={len(kernels)}", results)


def device_ms(fn, reps=5):
    """Median time of ``fn()`` on the card's stream (CUDA events) over
    ``reps`` calls after a warm one; it holds any gap the host leaves."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_ms(fn, reps=5):
    """Device time per ``fn()`` call of the band_pearson kernels alone,
    summed from a torch.profiler trace of ``reps`` calls after a warm one,
    or None when the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "band_pearson_tiled" in e.key)
    return us / reps / 1e3 if us else None


def fmt_ms(value):
    return "not measured" if value is None else f"{value:.3f}"


def fp64_rate():
    """Peak float64 FMAs per second, on the tensor cores (DMMA): SMs x 128
    per clock x the maximum SM clock (the data sheet's 67 TFLOP/s on an
    H100 SXM; the CUDA cores, which this kernel uses, issue half that)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    rate = sms * 128 * mhz * 1e6
    print(f"[kernels] float64 peak (tensor cores): {sms} SMs x 128 FMA per clock x "
          f"{mhz:.0f} MHz (clocks.max.sm) = {rate:.4g} per second")
    return rate


def bound_ms(sig_p, mask_p, kernels, rate):
    """(least time in ms, "operations" or "bytes", FMAs needed, FMAs of
    the dense 3K mk nk count) of one launch on these framed inputs.  The operations these inputs need: per output
    pixel, K FMAs for each window tap over a non-zero x and 2K for each
    tap over a set mask bit (a zero operand changes no sum), and
    3(mk + nk) adds for the separable window sums, at ``rate``; the bytes:
    each input read once and each output written once, at the card's
    memory rate."""
    kernels = np.asarray(kernels)
    if kernels.ndim == 2:
        kernels = kernels[None]
    n_k, mk, nk = kernels.shape
    _, _, n_pad, w_out = bp._geometry(sig_p, mask_p, kernels)
    pixels = n_pad * w_out
    x_taps, _, m_taps = (float(s.sum()) for s in bp.separable_window_sums(
        (sig_p != 0).double(), (mask_p != 0).double(), mk, nk, n_pad, w_out))
    fmas = n_k * (x_taps + 2 * m_taps)
    dense = 3 * n_k * mk * nk * pixels
    ops = fmas + 3 * (mk + nk) * pixels
    nbytes = 2 * 4 * sig_p.numel() + pixels * n_k * 9 + n_k * (3 * mk * nk * 8 + 8)
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] work {n_k}x{mk}x{nk} on ({n_pad}, {w_out}): taps on x "
          f"{x_taps / (pixels * mk * nk):.4f}, on mask {m_taps / (pixels * mk * nk):.4f}; "
          f"{fmas:.6g} of {dense:.6g} FMAs")
    return (t_ops, "operations", fmas, dense) if t_ops >= t_bytes else (
        t_bytes, "bytes", fmas, dense)


def phase_kernels_small():
    for preset in ("loops_small", "hairpins", "loops", "stripes_left"):
        kernel = np.asarray(load_kernel_config(preset)["kernels"][0], np.float32)
        case = random_case(kernel.shape, 300, 512, np.random.RandomState(0))
        run_both(f"{preset}", *case[:2], kernel, 300, case[2])
    for shape in ((5, 9), (3, 17)):
        rng = np.random.RandomState(11)
        kernel = (rng.rand(*shape) + 0.1).astype(np.float32)
        case = random_case(shape, 300, 512, rng)
        run_both(f"{shape}", *case[:2], kernel, 300, case[2])
    cfg = load_kernel_config("centromeres")
    kernel = cfg["kernels"][0]
    case = random_case(kernel.shape, 400, 400, np.random.RandomState(2))
    run_both("centromeres 81x81 n=400", *case[:2], kernel, 400, case[2], cfg["pearson"])
    kernel = load_kernel_config("loops")["kernels"][0]
    case = random_case(kernel.shape, 300, 512, np.random.RandomState(0))
    run_both("loops --tsvd", *case[:2], kernel, 300, case[2], tsvd=TSVD)
    borders = np.stack(load_kernel_config("borders")["kernels"])
    case = random_case(borders.shape[1:], 300, 512, np.random.RandomState(0))
    run_multi("borders", *case[:2], borders, 300, case[2])
    rng = np.random.RandomState(7)
    nine = rng.rand(9, 5, 9) + 0.1
    case = random_case((5, 9), 300, 512, rng)
    run_multi("nine 5x9", *case[:2], nine, 300, case[2])
    stripes = np.stack([load_kernel_config(name)["kernels"][0]
                        for name in ("stripes_left", "stripes_right", "stripes_left")])
    case = random_case(stripes.shape[1:], 300, 512, np.random.RandomState(4))
    run_multi("three 31x31 (2 + 1 launches)", *case[:2], stripes, 300, case[2])
    flush_reports("random bands, single and K kernels")
    two_streams()
    fp32_boundaries()


def two_streams(reps=8):
    """Launches of two tap tables on two streams at once (the tables share
    the constant bank) equal the same launches on one stream, bit for bit."""
    sig_p, mask_p, max_dist = random_case((17, 17), 300, 512, np.random.RandomState(5))
    stacks = (load_kernel_config("loops")["kernels"][0],
              np.stack(load_kernel_config("borders")["kernels"]))
    args = (300, max_dist, MISSING_TOL, PEARSON)
    want = [bp.band_pearson(sig_p, mask_p, s, *args) for s in stacks]
    streams = [torch.cuda.Stream() for _ in stacks]
    torch.cuda.synchronize()
    got = [[] for _ in stacks]
    for _ in range(reps):
        for stack, stream, out in zip(stacks, streams, got):
            with torch.cuda.stream(stream):
                out.append(bp.band_pearson(sig_p, mask_p, stack, *args))
    torch.cuda.synchronize()
    for ref, outs in zip(want, got):
        for out in outs:
            for a, b in zip(ref, out):
                check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
                      "launches on two streams differ from launches on one")
    print(f"[kernels] two streams: {reps} x 2 launches of two tap tables equal "
          "single-stream launches")


def fp32_oracle(sig_p, mask_p, kernel, threshold=1e-4):
    """The float64 oracle of tests/test_fp32_boundaries.py:40-77 on framed
    inputs (numpy): the six correlations and the missing-corrected
    Pearson with its guards, on the correlation's rows; (corr, n_pres)."""
    from scipy.signal import correlate2d

    k = np.asarray(kernel, np.float64)
    ksize = k.size
    sh_k, sh_k2, sh_1 = (shear_kernel(a) for a in (k, k**2, np.ones_like(k)))

    def snap(x):
        x = np.asarray(x)
        x[np.abs(x) < threshold] = 0.0
        return x

    conv_sk = snap(correlate2d(sig_p, sh_k / ksize, mode="valid"))
    sig_mean0 = snap(correlate2d(sig_p, sh_1, mode="valid") / ksize)
    sig2_mean0 = snap(correlate2d(sig_p**2, sh_1, mode="valid") / ksize)
    n_miss = snap(correlate2d(mask_p, sh_1, mode="valid"))
    conv_mk = snap(correlate2d(mask_p, sh_k, mode="valid"))
    conv_mk2 = snap(correlate2d(mask_p, sh_k2, mode="valid"))
    with np.errstate(divide="ignore", invalid="ignore"):
        n_pres = ksize - n_miss
        kmean_eff = (k.sum() - conv_mk) / n_pres
        k2mean_eff = ((k**2).sum() - conv_mk2) / n_pres
        corr_f = ksize / n_pres
        sig_mean = sig_mean0 * corr_f
        sig2_mean = sig2_mean0 * corr_f
        denom = np.sqrt((sig2_mean - sig_mean**2) * (k2mean_eff - kmean_eff**2))
        denom[n_pres < int((1 - MISSING_TOL) * ksize)] = 0.0
        num = (conv_sk - sig_mean * kmean_eff / corr_f) * corr_f
        out = np.where(np.abs(denom) < 1e-10, 0.0, num / denom)
    out[~np.isfinite(out)] = 0.0
    np.clip(out, -1.0, 1.0, out=out)
    return out, n_pres


def fp32_cases(kernel):
    """The bands of tests/test_fp32_boundaries.py:127, :171 and :222:
    {name: (band, missing)}."""
    n, width = FP32_N, FP32_WIDTH
    rng = np.random.default_rng(7)
    band = 1.0 + 0.2 * rng.standard_normal((n, width))
    missing = np.zeros(n, bool)
    for idx in (96, np.arange(132, 140), np.arange(293, 299), np.arange(333, 337)):
        missing[idx] = True
    band[missing, :] = 0.0
    ii, dd = np.indices(band.shape)
    band[np.isin(ii + dd, np.flatnonzero(missing))] = 0.0
    cases = {"min_pres": (band, missing)}
    rng = np.random.default_rng(13)
    band = 1.0 + 0.2 * rng.standard_normal((n, width))
    band[40:120, 10:90] = 1.0
    band[200, 40] += 0.1
    band[340:420, 10:90] = 1.0
    band[380, 40] += 5e-4
    cases["guard"] = (band, np.zeros(n, bool))
    rng = np.random.default_rng(29)
    mk, nk = kernel.shape
    kc = (kernel - kernel.mean()).ravel()
    kc /= np.linalg.norm(kc)
    q = rng.standard_normal(mk * nk)
    q -= q.mean()
    q -= (q @ kc) * kc
    q /= np.linalg.norm(q)
    band = np.full((n, width), 1.0)
    for (r, d), rho in fp32_targets().items():
        patch = (1.0 + rho * kc + np.sqrt(1 - rho**2) * q).reshape(mk, nk)
        for u in range(mk):
            for v in range(nk):
                band[r - 8 + u, d - u + v] = patch[u, v]
    cases["straddle"] = (band, np.zeros(n, bool))
    return cases


def fp32_targets():
    return {(60, 40): PEARSON + 1e-2, (140, 40): PEARSON - 1e-2,
            (220, 40): PEARSON + 1e-6, (300, 40): PEARSON - 1e-6}


def fp32_boundaries():
    """The three fp32 decision boundaries of tests/test_fp32_boundaries.py
    through the CUDA kernel, each held to the float64 oracle with that
    file's bounds (the guard case: no zero/non-zero disagreement outside
    the variance region, and its two near-zero windows within 1e-7 of the
    oracle)."""
    kernel = np.asarray(load_kernel_config("loops")["kernels"][0], np.float64)
    mk, nk = kernel.shape
    n, max_dist = FP32_N, FP32_MAX_DIST
    for name, (band, missing) in fp32_cases(kernel).items():
        sig_p, mask_p = band_frame(
            torch.from_numpy(band.astype(np.float32)).to(DEVICE),
            torch.from_numpy(missing).to(DEVICE), (mk, nk), n, max_dist)
        corr32 = bp.band_pearson(sig_p, mask_p, kernel, n, max_dist, MISSING_TOL,
                                 PEARSON)[0].double().cpu().numpy()
        sig64, mask64 = sig_p.double().cpu().numpy(), mask_p.double().cpu().numpy()
        corr64, n_pres = fp32_oracle(sig64, mask64, kernel)
        kh = (mk - 1) // 2
        corr64, n_pres = corr64[kh : kh + n], n_pres[kh : kh + n]
        i, d = np.indices(corr64.shape)
        corr64[~((d <= max_dist) & (i < n) & (i + d < n))] = 0.0
        if name == "min_pres":
            a, b = (100, 40), (300, 40)
            min_pres = int((1 - MISSING_TOL) * mk * nk)
            ok = (n_pres[a] == min_pres and n_pres[b] == min_pres - 1
                  and corr32[a] != 0 and corr64[a] != 0 and corr32[b] == 0 == corr64[b]
                  and abs(corr32[a] - corr64[a]) < 5e-5)
            detail = f"kept at n_pres {n_pres[a]:.0f}, dropped at {n_pres[b]:.0f}, " \
                     f"|d| {abs(corr32[a] - corr64[a]):.3g}"
        elif name == "guard":
            sh_1 = shear_kernel(np.ones((mk, nk)))
            from scipy.signal import correlate2d

            m1 = correlate2d(sig64, sh_1, mode="valid") / (mk * nk)
            m2 = correlate2d(sig64**2, sh_1, mode="valid") / (mk * nk)
            var64 = (m2 - m1**2)[kh:][:n]
            flip = (corr32 == 0.0) != (corr64 == 0.0)
            out = flip & (var64 >= 1e-5)
            near = [abs(corr32[p] - corr64[p]) for p in ((179, 41), (179, 48))]
            ok = (corr32[64, 40] == 0 == corr64[64, 40] and corr32[200, 40] != 0
                  and corr64[200, 40] != 0 and not out.any() and max(near) < 1e-7)
            detail = (f"{int(flip.sum())} zero/non-zero disagreements, {int(out.sum())} outside "
                      f"the variance region; (179, 41), (179, 48): {corr32[179, 41]:.4g}, "
                      f"{corr32[179, 48]:.4g} (|d| {near[0]:.2g}, {near[1]:.2g}); map max|d| "
                      f"{np.abs(corr32 - corr64).max():.3g}")
        else:
            errs = [abs(corr32[p] - rho) for p, rho in fp32_targets().items()]
            sides = all((corr32[p] >= PEARSON) == (rho >= PEARSON)
                        for p, rho in fp32_targets().items() if abs(rho - PEARSON) > 1e-3)
            ok = max(errs) < 5e-5 and sides and all(
                abs(corr64[p] - rho) < 1e-6 for p, rho in fp32_targets().items())
            detail = f"max |d| to the built scores {max(errs):.3g}, clear sides kept {sides}"
        print(f"[kernels] fp32 boundary {name} through the CUDA kernel: {detail}")
        check(ok, f"fp32 boundary {name}: {detail}")


def chromosome_case(source, preset):
    """The framed inputs the main path gives the kernel on chr1, with the
    preset's scan distance: (contact map, kernels, sig_p, mask_p)."""
    cfg = load_kernel_config(preset)
    genome = HicGenome(source, kernel_config=cfg, device=DEVICE)
    genome.normalize("auto")
    genome.make_sub_matrices()
    cm = genome.sub_mats.contact_map[0]
    cm.create_mat()
    kernels = np.stack(cfg["kernels"])
    sig_p, mask_p = frame_contact_map(cm, kernels.shape[1:])
    return cm, cfg, kernels, sig_p, mask_p


def phase_kernels_chromosome(source):
    """Kernel vs plain, and device times, on chr1 of the genome: loops
    (single-kernel mode, and its --tsvd taps) and borders (K = 3) on the
    framed inputs their main paths give the kernel, then the borders
    kernels at the loops band's width, where the sweep does real work."""
    times, bounds = {}, {}
    rate = fp64_rate()
    cm, cfg, kernels, sig_p, mask_p = chromosome_case(source, "loops")
    n, max_dist = cm.shape[0], cm.max_dist
    shape = tuple(cm.band_dev.shape)
    run_both(f"loops {cm.name} {shape}", sig_p, mask_p, kernels[0], n, max_dist)
    run_both(f"loops --tsvd {cm.name} {shape}", sig_p, mask_p, kernels[0], n, max_dist,
             tsvd=TSVD)
    args = (n, max_dist, MISSING_TOL, PEARSON)
    single = {
        "loops": lambda: bp.band_pearson(sig_p, mask_p, kernels[0], *args),
        "tsvd": lambda: bp.band_pearson(sig_p, mask_p, kernels[0], *args, tsvd=TSVD),
    }
    for key, fn in single.items():
        tsvd = TSVD if key == "tsvd" else None
        times[key] = (device_ms(fn), kernel_ms(fn), device_ms(
            lambda: pearson_reference(sig_p, mask_p, kernels[0], *args, tsvd=tsvd)))
    borders = np.stack(load_kernel_config("borders")["kernels"])
    run_multi(f"borders at the loops band {shape}", sig_p, mask_p, borders, n, max_dist)
    times["borders_wide"] = fused_times(sig_p, mask_p, borders, args)
    bounds["loops"] = bounds["tsvd"] = bound_ms(sig_p, mask_p, kernels[0], rate)
    bounds["borders_wide"] = bound_ms(sig_p, mask_p, borders, rate)
    cm.destroy_mat()
    del sig_p, mask_p
    cm, cfg, kernels, sig_p, mask_p = chromosome_case(source, "borders")
    bshape = tuple(cm.band_dev.shape)
    bargs = (cm.shape[0], cm.max_dist, cfg["max_perc_undetected"] / 100, cfg["pearson"])
    run_multi(f"borders {cm.name} {bshape}", sig_p, mask_p, kernels, *bargs[:2],
              bargs[3])
    times["borders"] = fused_times(sig_p, mask_p, kernels, bargs)
    bounds["borders"] = bound_ms(sig_p, mask_p, kernels, rate)
    cm.destroy_mat()
    flush_reports("chr1 of the genome")
    print("[kernels] ms a call, kernel-only (profiler) / CUDA events, median of 5; bound, its "
          "share (of events); float64 FMAs per second (T) needed / dense; plain twin")
    timed = {"loops": times["loops"][:2], "tsvd": times["tsvd"][:2],
             "borders_wide": times["borders_wide"]["fused"],
             "borders": times["borders"]["fused"]}
    for key, name in (("loops", f"loops 17x17 at {shape}"),
                      ("tsvd", f"loops 17x17 --tsvd at {shape}"),
                      ("borders_wide", f"borders K=3 at {shape}"),
                      ("borders", f"borders K=3 at {bshape}")):
        b, by, fmas, dense = bounds[key]
        ev, ms = timed[key]
        share = "not measured" if ms is None else f"{100 * b / ms:.1f}%"
        rates = "not measured" if ms is None else (
            f"{fmas / ms / 1e9:.4g} / {dense / ms / 1e9:.4g}")
        if key in ("loops", "tsvd"):
            plain = f"plain {times[key][2]:.3f}"
        else:
            t = times[key]
            plain = (f"3 single launches {fmt_ms(t['three'][1])} / {t['three'][0]:.3f}, plain "
                     f"{t['plain']:.3f}")
        print(f"[kernels] {name}: {fmt_ms(ms)} / {ev:.3f}; bound {b:.4f} ({by}), {share} "
              f"({100 * b / ev:.1f}%); {rates}; {plain}")
    return times, bounds


def fused_times(sig_p, mask_p, kernels, args):
    """One K-kernel launch, K single launches (events, profiler) and the
    plain K-kernel twin (events), on the same framed inputs."""
    def fused():
        return bp.band_pearson(sig_p, mask_p, kernels, *args)

    def three():
        return [bp.band_pearson(sig_p, mask_p, k, *args) for k in kernels]

    return {
        "fused": (device_ms(fused), kernel_ms(fused)),
        "three": (device_ms(three), kernel_ms(three)),
        "plain": device_ms(lambda: pearson_reference_multi(sig_p, mask_p, kernels, *args)),
    }


def short_path(uri):
    """A file's name, with its group (``x.mcool::/resolutions/1000``)."""
    path, sep, group = str(uri).partition("::")
    return os.path.basename(path) + sep + group


def read_tsv(path):
    with open(path) as handle:
        return list(csv.DictReader(handle, delimiter="\t"))


def num(value):
    return float(value) if value != "" else float("nan")


def golden_detect(workdir, golden, flags, expect, tol=1e-5, path=EXAMPLE_COOL, tag="",
                  show=True):
    """``detect`` of ``path`` with ``flags`` against tests/data/<golden>.tsv:
    the same (bin1, bin2, kernel_id, iteration) calls, score within 5e-5,
    p-value and q-value within ``tol`` (1e-6 for the loops golden, 1e-5
    for the others, as tests/test_golden_outputs.py holds them);
    ``expect`` the launches of each mode; the table at
    ``{workdir}/{golden}{tag}.tsv``; its line printed when ``show``."""
    prefix = f"{workdir}/{golden}{tag}"
    reset_launches()
    with open(f"{workdir}/stdout.txt", "a") as out:
        stdout, sys.stdout = sys.stdout, out
        try:
            rc = main(["detect", "--no-plotting", *flags, path, prefix], device=DEVICE)
        finally:
            sys.stdout = stdout
    check(rc == 0, f"{golden}: detect failed")
    seen = launches()
    key = ("bin1", "bin2", "kernel_id", "iteration")
    ours = {tuple(r[k] for k in key): r for r in read_tsv(prefix + ".tsv")}
    ref = {tuple(r[k] for k in key): r for r in read_tsv(f"tests/data/{golden}.tsv")}
    check(ours.keys() == ref.keys(),
          f"{golden}: calls differ from the golden ({len(ours)} vs {len(ref)})")
    err = {c: max(abs(num(ours[k][c]) - num(ref[k][c])) for k in ref)
           for c in ("score", "pvalue", "qvalue")}
    if show:
        print(f"[golden] {golden[len('golden_'):]}, {short_path(path)}: {len(ref)}/{len(ref)} "
              f"calls; max|d| score {err['score']:.3g}, p {err['pvalue']:.3g}, q "
              f"{err['qvalue']:.3g} (bound {tol:g}); {seen}")
    check(err["score"] < 5e-5 and err["pvalue"] < tol and err["qvalue"] < tol,
          f"{golden}: {err}")
    check(seen == expect, f"{golden}: expected launches {expect}, saw {seen}")
    return prefix


def golden_quantify(workdir, golden, flags, pvalue_tol, path=EXAMPLE_COOL, tag="", show=True):
    """``quantify`` of data_test/example.bed2 from ``path`` against
    tests/data/<golden>.tsv (tests/test_golden_outputs.py:124-173); its
    line printed when ``show``."""
    prefix = f"{workdir}/{golden}{tag}"
    reset_launches()
    check(main(["quantify", "--no-plotting", *flags, "data_test/example.bed2",
                path, prefix], device=DEVICE) == 0,
          f"{golden}: quantify failed")
    ours = {(r["bin1"], r["bin2"]): r for r in read_tsv(prefix + ".tsv")}
    ref = {(r["bin1"], r["bin2"]): r for r in read_tsv(f"tests/data/{golden}.tsv")}
    check(ours.keys() == ref.keys() and len(ref) == 53, f"{golden}: rows differ")
    err = {}
    for col in ("score", "pvalue"):
        a = np.array([num(ours[k][col]) for k in ref])
        b = np.array([num(ref[k][col]) for k in ref])
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"{golden}: NaN {col} differ")
        ok = ~np.isnan(b)
        err[col] = float(np.abs(a[ok] - b[ok]).max())
    check(all(ours[k]["qvalue"] == "" for k in ref), f"{golden}: q-values not NaN")
    if show:
        print(f"[golden] {golden[len('golden_'):]}, {short_path(path)}: 53/53 rows, max|d| "
              f"score {err['score']:.3g}, p {err['pvalue']:.3g}; {launches()} (no sweep)")
    check(err["score"] < 5e-5 and err["pvalue"] < pvalue_tol, f"{golden}: {err}")


def golden_dump(workdir):
    """``--dump`` snapshots against tests/data/golden_dump/ as
    tests/test_golden_outputs.py:268-330 compares them."""
    import pathlib

    import scipy.sparse as sp

    dump = pathlib.Path(workdir) / "dump"
    golden_detect(workdir, "golden_detect_loops", ["--dump", str(dump)],
                  {"single": 3, "multi": 0}, tol=1e-6, show=False)
    names = sorted(p.name for p in pathlib.Path("tests/data/golden_dump").glob("*.npz"))
    check(sorted(p.name for p in dump.glob("*.npz")) == names and len(names) == 15,
          "dump snapshots differ in name")
    worst = {}
    for name in names:
        ref = sp.load_npz(f"tests/data/golden_dump/{name}").toarray()
        ours = sp.load_npz(dump / name).toarray()
        stage = name.split("_", 1)[1][:2]
        check(ours.shape == ref.shape, f"{name}: shape")
        if stage == "05":
            check(np.array_equal(ours, ref), f"{name}: foci labels differ")
            continue
        if stage == "03":
            ours04 = sp.load_npz(dump / name.replace("_03_normxcorr2", "_04_diag_trim"))
            check(np.array_equal(ours, ours04.toarray()), f"{name}: 03 != 04")
            continue
        if stage in ("01", "02"):
            ours, ref = np.triu(ours), np.triu(ref)
        check(np.array_equal(np.isnan(ours), np.isnan(ref)), f"{name}: NaN differ")
        d = np.abs(np.nan_to_num(ours) - np.nan_to_num(ref))
        if stage == "04":
            check(d.max() < 2e-4, f"{name}: corr differs by {d.max()}")
        else:
            check(np.allclose(np.nan_to_num(ours), np.nan_to_num(ref),
                              rtol=1e-5, atol=1e-6), f"{name}: differs")
        worst[stage] = max(worst.get(stage, 0.0), float(d.max()))
    print(f"[golden] --dump: 15/15 snapshots match; max|d| by stage "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in sorted(worst.items())})}")


def golden_windows(prefix):
    """The windows of the loops golden run (``--win-fmt json``) against
    tests/data/golden_detect_loops.json as tests/test_golden_outputs.py:
    235-265 compares them: matched by (bin1, bin2), the NaN pattern
    equal, rtol 1e-5 and atol 1e-6."""
    golden = read_tsv("tests/data/golden_detect_loops.tsv")
    ours = {(r["bin1"], r["bin2"]): i for i, r in enumerate(read_tsv(prefix + ".tsv"))}
    with open("tests/data/golden_detect_loops.json") as fh:
        ref_wins = json.load(fh)
    with open(prefix + ".json") as fh:
        our_wins = json.load(fh)
    check(len(our_wins) == len(ref_wins) == 89, "windows: count")
    worst = 0.0
    for gi, row in enumerate(golden):
        g = np.asarray(ref_wins[str(gi)], dtype=np.float64)
        o = np.asarray(our_wins[str(ours[(row["bin1"], row["bin2"])])], dtype=np.float64)
        check(g.shape == o.shape == (17, 17), "windows: shape")
        check(np.array_equal(np.isnan(g), np.isnan(o)), f"windows {gi}: NaN pattern")
        check(np.allclose(g, o, rtol=1e-5, atol=1e-6, equal_nan=True), f"windows {gi}")
        worst = max(worst, float(np.nanmax(np.abs(g - o), initial=0.0)))
    print(f"[golden] windows (--win-fmt json): 89/89 match golden_detect_loops.json, "
          f"NaN patterns equal, max|d| {worst:.3g}")


def phase_golden(workdir):
    golden_windows(golden_detect(workdir, "golden_detect_loops", [],
                                 {"single": 3, "multi": 0}, tol=1e-6))
    for golden, flags in (
        ("golden_detect_loops_raw", ["--norm", "raw"]),
        ("golden_detect_loops_smooth", ["--smooth-trend"]),
        ("golden_detect_loops_tsvd", ["--tsvd"]),
    ):
        golden_detect(workdir, golden, flags, {"single": 3, "multi": 0})
    golden_detect(workdir, "golden_detect_borders", ["--pattern", "borders"],
                  {"single": 0, "multi": 3})
    golden_dump(workdir)
    golden_detect(workdir, "golden_detect_loops", [], {"single": 3, "multi": 0}, tol=1e-6,
                  path=COOLER_LAYOUT)
    golden_quantify(workdir, "golden_quantify_loops", [], 1e-6)
    golden_quantify(workdir, "golden_quantify_borders", ["--pattern", "borders"], 5e-5)


def timed_read(path):
    """The port's reader on every object of ``path``: seconds to open it
    and walk its object headers, to walk every chunk index, and to read
    every dataset; the structures it walked, by signature."""
    t0 = time.perf_counter()
    with hdf5.File(path) as f:
        datasets, groups = [], [f.root]
        while groups:
            group = groups.pop()
            for name in group.keys():
                obj = group[name]
                (groups if isinstance(obj, hdf5.Group) else datasets).append(obj)
        t1 = time.perf_counter()
        for d in datasets:
            if d._class == 2:
                d._chunk_index()
        t2 = time.perf_counter()
        n_bytes = sum(d[()].nbytes for d in datasets)
        t3 = time.perf_counter()
        return (t1 - t0, t2 - t1, t3 - t2), len(datasets), n_bytes, dict(f.walked)


def phase_formats(workdir):
    """The example's goldens from the newer-format fixtures, through the
    command line on the card: tables byte for byte those from
    data_test/example.cool, the band kernel launched on every map."""
    expect_walked = {LATEST_COOL: ("superblock v3", "OHDR", "BTHD type 8", "FHDB", "EAHD", "EAIB",
                                   "EADB", "FAHD", "FADB", "chunk index 1"),
                     LATEST_MCOOL: ("superblock v3", "BTHD type 5", "FHDB", "EAHD", "FAHD",
                                    "LZF chunk")}
    timings = []
    for path, signatures in expect_walked.items():
        (t_open, t_index, t_read), n, n_bytes, walked = timed_read(path)
        timings.append(f"{short_path(path)} {t_open:.6f} / {t_index:.6f} / {t_read:.6f} s "
                       f"({n} datasets, {n_bytes} B; " + " ".join(
                           f"{sig} {walked.get(sig, 0)}" for sig in signatures[:3]) + ", ...)")
        missing = [sig for sig in signatures if not walked.get(sig)]
        check(not missing, f"{path}: structures not walked: {missing}")
    print("[formats] open / index walk / read: " + "; ".join(timings))
    loops = ("golden_detect_loops", [], {"single": 3, "multi": 0}, 1e-6)
    borders = ("golden_detect_borders", ["--pattern", "borders"], {"single": 0, "multi": 3}, 1e-5)
    same_tables = []
    for (golden, flags, expect, tol), path in ((loops, LATEST_COOL), (borders, LATEST_COOL),
                                              (loops, f"{LATEST_MCOOL}::/resolutions/1000")):
        old = golden_detect(workdir, golden, flags, expect, tol, tag="_v0", show=False)
        new = golden_detect(workdir, golden, flags, expect, tol, path=path, tag="_latest",
                            show=False)
        same = pathlib.Path(new + ".tsv").read_bytes() == pathlib.Path(old + ".tsv").read_bytes()
        same_tables.append(f"{golden[len('golden_detect_'):]} {short_path(path)}")
        check(same, f"{golden} from {path}: table differs from {EXAMPLE_COOL}'s")
    golden_quantify(workdir, "golden_quantify_loops", [], 1e-6, tag="_v0", show=False)
    golden_quantify(workdir, "golden_quantify_loops", [], 1e-6, path=LATEST_COOL, tag="_latest",
                    show=False)
    same = (pathlib.Path(f"{workdir}/golden_quantify_loops_latest.tsv").read_bytes()
            == pathlib.Path(f"{workdir}/golden_quantify_loops_v0.tsv").read_bytes())
    check(same, "quantify table differs")
    same_tables.append(f"quantify {short_path(LATEST_COOL)}")
    print(f"[formats] {EXAMPLE_COOL}'s tables byte for byte: " + ", ".join(same_tables))

    # --norm force on a weightless newer-format copy and on a copy of
    # example.cool: ICE on the host, the weights stored by the port's writer
    old, new = f"{workdir}/formats_force_v0.cool", f"{workdir}/formats_force_latest.cool"
    shutil.copy(EXAMPLE_COOL, old)
    shutil.copy(LATEST_COOL, new)
    with hdf5.File(new, "r+") as f:
        f.unlink("bins/weight")
        chunks = len(f._v2_chunks(f["bins"].addr)[1])
    check(CoolFile(new).weights is None, "bins/weight not dropped")
    runs = {}
    for path in (old, new):
        reset_launches()
        t0 = time.perf_counter()
        quiet = io.StringIO()
        with contextlib.redirect_stdout(quiet), contextlib.redirect_stderr(quiet):
            check(main(["detect", "--no-plotting", "--norm", "force", path, path + ".out"],
                       device=DEVICE) == 0, f"--norm force on {path} failed")
        runs[path] = (time.perf_counter() - t0, launches(),
                      pathlib.Path(path + ".out.tsv").read_bytes())
    weights = CoolFile(new).weights
    same_w = weights.tobytes() == CoolFile(old).weights.tobytes()
    same_t = runs[new][2] == runs[old][2]
    with hdf5.File(new) as f:
        bins = f["bins"]
        grew = len(f._v2_chunks(bins.addr)[1]) > chunks
        where = "a new OCHK chunk" if grew else "a NIL message"
    print(f"[formats] --norm force on {short_path(LATEST_COOL)} without weights: "
          f"{np.isfinite(weights).sum()} stored through {where} of bins, example.cool's: "
          f"{same_w}, tables {same_t}; walls {runs[new][0]:.3f} / {runs[old][0]:.3f} s; "
          f"{runs[new][1]}")
    check(same_w and same_t, "--norm force on the newer-format copy differs")
    check(runs[new][1] == {"single": 3, "multi": 0}, f"--norm force launches {runs[new][1]}")
    feature_fixtures(workdir, CoolFile(old).weights, runs[old][2])


def feature_fixtures(workdir, forced, forced_table):
    """Each of ``FEATURE_FIXTURES`` read by the port (the structure of its
    feature walked), its loops, borders and quantify tables byte for byte
    those from data_test/example.cool (the ``_v0`` tables of
    ``phase_formats``), 3 single launches for loops, and ``--norm force``
    on a copy (with the files it reads) storing ``forced``, the weights
    forced into a copy of example.cool, bit for bit, and giving that run's
    table, ``forced_table``, byte for byte."""
    example = {run: pathlib.Path(f"{workdir}/{name}_v0.tsv").read_bytes() for run, name in (
        ("loops", "golden_detect_loops"), ("borders", "golden_detect_borders"),
        ("quantify", "golden_quantify_loops"))}
    check(np.isfinite(forced).sum() == 637, f"{np.isfinite(forced).sum()} forced weights")
    done = []
    for feature, uri, extra, walk in FEATURE_FIXTURES:
        path = uri.partition("::")[0]
        check(os.path.exists(path), f"{path}: the {feature} fixture is missing")
        source = CoolFile(uri)
        source._pixels(0, source.nnz)
        walked = source._file.walked[walk]
        check(walked > 0, f"{uri}: {walk!r} not walked")
        seen = {}
        for run in ("loops", "borders", "quantify"):
            prefix = f"{workdir}/feature_{len(done)}_{run}"
            if run == "quantify":
                argv = ["quantify", "--no-plotting", "data_test/example.bed2", uri, prefix]
            else:
                argv = ["detect", "--no-plotting", *(["--pattern", "borders"] if run ==
                                                      "borders" else []), uri, prefix]
            reset_launches()
            quiet = io.StringIO()
            with contextlib.redirect_stdout(quiet), contextlib.redirect_stderr(quiet):
                check(main(argv, device=DEVICE) == 0, f"{run} from {uri} failed")
            seen[run] = launches()
            check(pathlib.Path(prefix + ".tsv").read_bytes() == example[run],
                  f"{run} from {uri}: table differs from {EXAMPLE_COOL}'s")
        check(seen["loops"] == {"single": 3, "multi": 0}, f"{uri}: loops launches {seen}")
        copies = f"{workdir}/feature_{len(done)}"
        os.makedirs(copies)
        for name in (path, *extra):
            shutil.copy(name, copies)
        copy = f"{copies}/{os.path.basename(path)}" + uri[len(path):]
        quiet = io.StringIO()
        with contextlib.redirect_stdout(quiet), contextlib.redirect_stderr(quiet):
            check(main(["detect", "--no-plotting", "--norm", "force", copy, f"{copies}/out"],
                       device=DEVICE) == 0, f"--norm force on {copy} failed")
        check(CoolFile(copy).weights.tobytes() == forced.tobytes(),
              f"--norm force on {copy}: weights differ from example.cool's")
        check(pathlib.Path(f"{copies}/out.tsv").read_bytes() == forced_table,
              f"--norm force on {copy}: table differs")
        done.append(f"{feature} {walked}")
    print("[formats] feature fixtures (structures walked), loops, borders, quantify and --norm "
          "force (637 weights) as from example.cool: " + "; ".join(done))


def tile_counts():
    """The tiled engine's counters (``tiles: <kind>`` of
    ``observability.counters()``) by kind."""
    counts = observability.counters()
    return {kind: counts.get(f"tiles: {kind}", 0)
            for kind in ("scanned", "skipped", "scattered", "batches", "launches")}


def run_genome(name, fn, tag="genome", show="short"):
    """One main-path run on a genome: launches counted from 0, stages
    (kept in ``STAGES``), wall (kept in ``WALLS``) and peak device memory,
    printed on one line (``show`` "short"), with the stages ("stages"),
    or left to the caller (None)."""
    reset_stages()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    wall = WALLS[name] = time.perf_counter() - t0
    seen = launches()
    STAGES[name] = stage_seconds()
    if show:
        print(f"[{tag}] {name}: wall {wall:.2f} s, launches {seen}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB" + ("; stages (s) " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(STAGES[name].items()))
                  if show == "stages" else ""))
    return out, seen


def write_planted_bed2d(source, path):
    """The planted loops as a bed2d file (one-bin anchors)."""
    with open(path, "w") as handle:
        handle.write("chrom1\tstart1\tend1\tchrom2\tstart2\tend2\n")
        for chrom, i, j in source.planted:
            handle.write(f"{chrom}\t{i * BINSIZE}\t{(i + 1) * BINSIZE}\t"
                         f"{chrom}\t{j * BINSIZE}\t{(j + 1) * BINSIZE}\n")


def check_quantify_against_sweep(source, table):
    """chr1's quantify scores (patch matmul) against the sweep kernel's
    corr at the same pixels, on the band quantify scanned."""
    cfg = load_kernel_config("loops")
    sel = table["chrom1"] == "chr1"
    span = int(np.max(table["start2"] - table["start1"]))
    cfg["max_dist"] = span
    genome = HicGenome(source, kernel_config=cfg, device=DEVICE)
    genome.normalize("auto")
    genome.make_sub_matrices()
    cm = genome.sub_mats.contact_map[0]
    cm.create_mat()
    coords = np.stack([table["bin1"][sel], table["bin2"][sel]], 1).astype(np.int64)
    at = quantify_banded(cm, cfg, cfg["kernels"], coords)[0][0]
    sig_p, mask_p = frame_contact_map(cm, cfg["kernels"][0].shape)
    corr = bp.band_pearson(sig_p, mask_p, cfg["kernels"][0], cm.shape[0], cm.max_dist,
                           cfg["max_perc_undetected"] / 100, cfg["pearson"])[0]
    swept = corr[torch.from_numpy(coords[:, 0]).to(DEVICE),
                 torch.from_numpy(coords[:, 1] - coords[:, 0]).to(DEVICE)].cpu().numpy()
    ok = ~np.isnan(at["score"])
    err = float(np.abs(at["score"][ok] - swept[ok]).max())
    print(f"[genome] quantify chr1: {int(ok.sum())}/{len(ok)} scored pixels within "
          f"{err:.3g} of the sweep kernel's corr on {tuple(cm.band_dev.shape)}")
    check(err < 2e-5, f"quantify differs from the sweep by {err}")
    check(np.allclose(at["score"], table["score"][sel], equal_nan=True),
          "chr1 quantify differs from the genome run")
    cm.destroy_mat()


def phase_genome(source, workdir):
    runs = {}
    args = parse_args(["detect", "--no-plotting", "synthetic", f"{workdir}/genome"], "")
    (table, _), seen = run_genome("detect loops", lambda: detect(source, args, DEVICE),
                                  show="stages")
    runs["loops"] = seen
    recall = planted_recall(source, table)
    print(f"[genome] {len(source.chromnames)} x {GENOME_BINS} bins, loops: "
          f"{len(table['bin1'])} calls, recall {recall:.4f} ({len(source.planted)} "
          f"planted, +-2 bins)")
    n_chroms = len(source.chromnames)
    band_uploads(source, "genome")
    check(seen == {"single": n_chroms, "multi": 0}, f"loops launches {seen}")
    check(recall >= 0.95, f"recall {recall} below 0.95")
    check(all(np.isfinite(table["score"])) and all(np.isfinite(table["pvalue"])),
          "non-finite scores")

    args = parse_args(["detect", "--no-plotting", "--pattern", "borders", "synthetic",
                       f"{workdir}/borders"], "")
    (table, _), seen = run_genome("detect borders", lambda: detect(source, args, DEVICE),
                                  show="stages")
    runs["borders"] = seen
    n_calls = 0 if table is None else len(table["bin1"])
    print(f"[genome] borders: {n_calls} calls from {seen['multi']} fused launches")
    band_uploads(source, "genome")
    check(seen == {"single": 0, "multi": n_chroms}, f"borders launches {seen}")
    if table is not None:
        check(all(np.isfinite(table["score"])), "non-finite border scores")

    bed = f"{workdir}/planted.bed2"
    write_planted_bed2d(source, bed)
    args = parse_args(["quantify", "--no-plotting", bed, "synthetic",
                       f"{workdir}/quantify"], "")
    (table, windows), seen = run_genome(
        "quantify planted loops", lambda: quantify(source, args, DEVICE), show="stages"
    )
    runs["quantify"] = seen
    band_uploads(source, "genome")
    scored = ~np.isnan(table["score"])
    print(f"[genome] quantify: {len(table['score'])} pairs, {int(scored.sum())} scored, "
          f"median score {np.nanmedian(table['score']):.4f}, "
          f"{int((table['score'][scored] >= 0.3).sum())} at or above 0.3")
    check(len(table["score"]) == len(source.planted) == windows.shape[0],
          "quantify rows differ from the planted loops")
    check(scored.mean() > 0.9 and np.nanmedian(table["score"]) > 0.3,
          "planted loops score low")
    check(seen == {"single": 0, "multi": 0}, f"quantify swept the band: {seen}")
    check_quantify_against_sweep(source, table)
    compare_f32_path(source, workdir, bed, runs)
    check_count_modes(source)
    return runs


def check_count_modes(source):
    """chr1's band made on the card through each count mode (u4, u8 and
    u16, set by ``contact_map.COUNT_PACKING``) and through the f32 path,
    balanced and at --norm raw: every preprocessed band bit for bit the
    f32 path's."""
    cfg = load_kernel_config("loops")
    for norm in ("auto", "raw"):
        bands = {}
        for mode in (*COUNT_MODES, "f32"):
            with packing(None if mode == "f32" else mode):
                genome = HicGenome(source, kernel_config=cfg, device=DEVICE)
                quietly(genome.normalize, norm)
                genome.compute_max_dist()
                quietly(genome.make_sub_matrices)
                cm = genome.sub_mats.contact_map[0]
                observability.reset()
                cm.create_mat()
            got = observability.band_uploads()[cm.name]["mode"]
            check(got == mode, f"count modes: {mode} asked, {got} taken")
            bands[mode] = cm.band_dev.cpu().numpy().tobytes()
            cm.destroy_mat()
        shape = observability.band_uploads()[cm.name]["shape"]
        check(all(band == bands["f32"] for band in bands.values()),
              f"count modes at --norm {norm}: a band differs from the f32 path's")
    print(f"[genome] {cm.name} {shape} at --norm auto and raw: the u4, u8 and u16 count "
          f"paths' preprocessed bands bit for bit the f32 path's")


def compare_f32_path(source, workdir, bed, runs):
    """Loops, borders and quantify of the genome once more with
    ``contact_map.COUNT_PACKING = None`` (each chromosome's balanced float32
    band scattered on the host and uploaded): tables and windows byte for
    byte the count path's, the same launches; ``io: fetch+scatter``,
    ``io: upload`` and the wall of both paths side by side."""
    names = {"loops": ("detect loops", ["detect"], "genome"),
             "borders": ("detect borders", ["detect", "--pattern", "borders"], "borders"),
             "quantify": ("quantify planted loops", ["quantify", bed], "quantify")}
    with packing(None):
        for key, (name, cmd, prefix) in names.items():
            args = parse_args([cmd[0], "--no-plotting", *cmd[1:], "synthetic",
                               f"{workdir}/{prefix}_f32"], "")
            fn = quantify if cmd[0] == "quantify" else detect
            _, seen = run_genome(f"{name}, f32 path",
                                 lambda: quietly(fn, source, args, DEVICE), show=None)
            band_uploads(source, "genome", modes=("f32",))
            check(seen == runs[key], f"{name}, f32 path: launches {seen}")
            same = outputs(f"{workdir}/{prefix}_f32") == outputs(f"{workdir}/{prefix}")
            check(same and outputs(f"{workdir}/{prefix}"),
                  f"{name}: the f32 path's table or windows differ from the count path's")
    print(f"[genome] count path / f32 path: tables and windows byte for byte; "
          f"{nvidia_smi('name,power.limit')}")
    for name, _, _ in names.values():
        a, b = STAGES[name], STAGES[f"{name}, f32 path"]
        print(f"[genome]   {name} (s): " + ", ".join(
            f"{stage} {a.get(stage, 0.0):.3f} / {b.get(stage, 0.0):.3f}"
            for stage in ("io: fetch+scatter", "io: upload"))
            + f", wall {WALLS[name]:.2f} / {WALLS[f'{name}, f32 path']:.2f}")


def phase_surface_example(workdir):
    """``test``, ``list-kernels``, ``generate-config`` and ``--norm force``
    on the example map."""
    def offline(url, path):
        raise OSError("chip_smoke runs the self-test without a network")

    download, cli.download_file = cli.download_file, offline
    cwd = os.getcwd()
    os.chdir(workdir)
    err = io.StringIO()
    try:
        reset_launches()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            check(main(["test"], device=DEVICE) == 0, "test failed")
        seen = launches()
    finally:
        os.chdir(cwd)
        cli.download_file = download
    log = err.getvalue()
    lines = {u.strip("\x1b[K") for u in set(log.split("\n")) if "\r" not in u}
    n_calls = len(read_tsv(f"{workdir}/chromosight_test.tsv"))
    print(f"[surface] test: {n_calls} patterns from {os.path.relpath(cli.example_dataset())}, "
          "log lines "
          f"{'equal' if lines == set(cli.TEST_LOG.split(chr(10))) else 'differ from'} "
          f"TEST_LOG; launches {seen}")
    check(n_calls == 89 and lines == set(cli.TEST_LOG.split("\n")), "test log differs")
    check("test log differed" not in log, "test warned that its log differed")
    check(seen == {"single": 3, "multi": 0}, f"test launches {seen}")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(main(["list-kernels", "--long", "--mat"]) == 0, "list-kernels failed")
    names = [ln for ln in out.getvalue().splitlines() if ln and ln[0].isalpha()]
    check(names == cli.kernel_names and len(names) == 7, "list-kernels presets")
    print(f"[surface] list-kernels --long --mat: the {len(names)} presets of kernel_names, "
          f"{len(out.getvalue().splitlines())} lines")

    cfg = f"{workdir}/borders_cfg"
    check(main(["generate-config", "--preset", "borders", cfg]) == 0, "generate-config")
    golden_detect(workdir, "golden_detect_borders", ["--kernel-config", cfg + ".json"],
                  {"single": 0, "multi": 3}, show=False)
    print("[surface] generate-config --preset borders: detect --kernel-config of the "
          "file reproduces golden_detect_borders.tsv")

    # --norm force on copies of example.cool: ICE on the host, the weights
    # written into the copy by the port's HDF5 writer
    tables = {}
    for tag, device, norm in (("card", DEVICE, "force"), ("cpu", "cpu", "force"),
                              ("card_reopened", DEVICE, "auto")):
        cool = f"{workdir}/force_{tag.split('_')[0]}.cool"
        if norm == "force":
            shutil.copy(EXAMPLE_COOL, cool)
        prefix = f"{workdir}/force_{tag}"
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            check(main(["detect", "--no-plotting", "--norm", norm, cool, prefix],
                       device=device) == 0, f"--norm {norm} on the {tag} copy failed")
        tables[tag] = (read_tsv(prefix + ".tsv"), launches())
    (card, seen), (plain, _) = tables["card"], tables["cpu"]
    key = ("bin1", "bin2", "kernel_id", "iteration")
    same = [tuple(r[k] for k in key) for r in card] == [tuple(r[k] for k in key) for r in plain]
    err = max(abs(num(a["score"]) - num(b["score"])) for a, b in zip(card, plain))
    print(f"[surface] --norm force on a copy of {EXAMPLE_COOL}: {len(card)} calls on the "
          f"card, {len(plain)} on the CPU, identical {same}, score max|d| {err:.3g}; "
          f"launches {seen}")
    check(same and len(card) == 89 and err < 5e-5, "--norm force calls differ")
    check(seen == {"single": 3, "multi": 0}, f"--norm force launches {seen}")
    stored = CoolFile(f"{workdir}/force_card.cool")
    cpu_weights = CoolFile(f"{workdir}/force_cpu.cool").weights
    original = CoolFile(EXAMPLE_COOL).weights
    reopened = pathlib.Path(f"{workdir}/force_card_reopened.tsv").read_bytes()
    forced = pathlib.Path(f"{workdir}/force_card.tsv").read_bytes()
    print(f"[surface] --norm force: the copy reopened holds {np.isfinite(stored.weights).sum()} "
          f"weights, the CPU run's bit for bit: "
          f"{stored.weights.tobytes() == cpu_weights.tobytes()} (max|d| from the example's own "
          f"{np.nanmax(np.abs(stored.weights - original)):.3g}); --norm auto on it gives the "
          f"forced run's table: {reopened == forced}")
    check(stored.weights.tobytes() == cpu_weights.tobytes(), "stored weights differ")
    check(reopened == forced, "the stored weights are not the ones the run used")


def genome_run(source, workdir, tag, flags=(), device=DEVICE, rng=None):
    """``detect`` with ``flags`` on a genome source (counts from 0, wall,
    stages, peak memory): (table, launches, tsv and windows bytes)."""
    prefix = f"{workdir}/{tag}"
    args = parse_args(["detect", "--no-plotting", *flags, "synthetic", prefix], "")

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return detect(source, args, device, rng)

    (table, _), seen = run_genome(f"detect {tag}", run, show=None)
    out = pathlib.Path(prefix + ".tsv").read_bytes() + pathlib.Path(prefix + ".json").read_bytes()
    return table, seen, out


def scatter_seconds(source, counts=False, width=418):
    """Seconds of the native band scatter of every chromosome of the
    genome, on the calling thread: the balanced float32 band, or with
    ``counts`` the packed raw counts of the count path."""
    t0 = time.perf_counter()
    for chrom in source.chromnames:
        if counts:
            source.band_upper_counts_auto(source.extent(chrom), width,
                                          u4_head=contact_map.U4_HEAD)
        else:
            source.band_upper(source.extent(chrom), width, balance=True)
    return time.perf_counter() - t0


def on_new_thread(fn, *args):
    """``fn(*args)`` on a thread of its own; its result."""
    out = []
    thread = threading.Thread(target=lambda: out.append(fn(*args)))
    thread.start()
    thread.join()
    return out[0]


def phase_surface_genome(source, workdir):
    """On the 13 x 48,000 genome: ICE of the weightless source at --norm
    auto, --threads 1, 2 and 4 and two workers on the card, against
    phase 5's stored-weights run; then --subsample on three
    chromosomes."""
    stored = (pathlib.Path(f"{workdir}/genome.tsv").read_bytes()
              + pathlib.Path(f"{workdir}/genome.json").read_bytes())
    n_chroms = len(source.chromnames)
    bare = copy.copy(source)
    bare._weight = None
    table, seen, out = genome_run(bare, workdir, "ice")
    ice = stage_seconds().get("balance: ICE")
    recall = planted_recall(source, table)
    print(f"[surface] weights dropped, --norm auto: balance: ICE {ice:.3f} s (host); "
          f"table byte-identical to the stored-weights run: {out == stored}; recall "
          f"{recall:.4f}; launches {seen}")
    check(ice is not None and out == stored, "ICE run differs from the stored weights")
    check(recall >= 0.95 and seen == {"single": n_chroms, "multi": 0}, "ICE run recall")
    check(np.array_equal(bare.weights, source.weights, equal_nan=True), "ICE weights differ")
    walls, lines = {}, []
    # the serial run last again: the spread of one configuration
    for tag, flags, device in (("threads1", ["--threads", "1"], DEVICE),
                               ("threads2", ["--threads", "2"], DEVICE),
                               ("threads4", ["--threads", "4"], DEVICE),
                               ("two_workers", [], [DEVICE, DEVICE]),
                               ("threads1_again", ["--threads", "1"], DEVICE)):
        t0 = time.perf_counter()
        _, seen, out = genome_run(source, workdir, tag, flags, device)
        walls[tag] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        lines.append(f"{tag} {walls[tag]:.2f} s {peak:.3f} GiB")
        check(out == stored, f"{tag}: table differs from the serial run")
        check(seen == {"single": n_chroms, "multi": 0}, f"{tag}: launches {seen}")
    print(f"[surface] tables byte for byte the serial one, {n_chroms} single launches each; "
          "wall, peak device memory: " + "; ".join(lines))
    # why the scheduler's producer is the caller's thread
    shown = []
    for counts, what in ((False, "f32"), (True, "count")):
        times = [(scatter_seconds(source, counts), on_new_thread(scatter_seconds, source, counts))
                 for _ in range(2)]
        shown.append(f"{what} " + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in times))
    print("[surface] native scatter of the genome (s), main thread / a thread of its own: "
          + "; ".join(shown))

    first = SUBSAMPLE_CHROMS
    end = int(source._chrom_offset[first])
    cut = ArraySource(
        source.chromnames[:first], source._chrom_offset[: first + 1],
        source._bin_start[:end], source._bin_end[:end],
        *(a[: source._bin1_offset[end]] for a in (source.bin1, source.bin2, source.count)),
        weight=source.weights[:end], binsize=source.binsize,
    )
    cut.planted = [p for p in source.planted if p[0] in cut.chromnames]
    outs = {}
    for threads in ("1", "4"):
        t0 = time.perf_counter()
        table, seen, outs[threads] = genome_run(
            cut, workdir, f"subsample{threads}",
            ["--subsample", "0.5", "--perc-zero", "100", "--threads", threads],
            rng=np.random.RandomState(0))
        same = "" if threads == "1" else "; byte for byte --threads 1's (one seed)"
        if same:
            check(outs["1"] == outs["4"], "--subsample: --threads 4 differs from --threads 1")
        print(f"[surface] --subsample 0.5 --threads {threads} on {first} x {GENOME_BINS}: "
              f"{len(table['bin1'])} calls, recall {planted_recall(cut, table):.4f}, wall "
              f"{time.perf_counter() - t0:.2f} s, launches {seen}{same}")
        check(seen == {"single": first, "multi": 0}, f"--subsample launches {seen}")
        check(len(table["bin1"]) > 0, "--subsample: no call")


def inter_quantify(workdir, tag):
    """``quantify --inter`` of the four pairs; the rows as dicts."""
    bed = f"{workdir}/inter_pairs.bed2"
    with open(bed, "w") as handle:
        handle.write(INTER_PAIRS)
    prefix = f"{workdir}/inter_quantify_{tag}"
    check(main(["quantify", "--no-plotting", "--inter", bed,
                EXAMPLE_COOL, prefix], device=DEVICE) == 0,
          f"quantify --inter ({tag}) failed")
    return read_tsv(prefix + ".tsv")


def phase_golden_inter(workdir):
    """``detect --inter`` against golden_detect_loops_inter.tsv on the dense
    engine, then on the tiled engine (DENSE_LIMIT 50, tiles of 128), and
    ``quantify --inter`` of the four pairs on both engines: the same rows,
    NaN pattern and bins, scores within 5e-5."""
    rows = {}
    limit, tile = contact_map.DENSE_LIMIT, tiled.DEFAULT_TILE
    for tag in ("dense", "tiled"):
        if tag == "tiled":
            contact_map.DENSE_LIMIT, tiled.DEFAULT_TILE = 50, 128
        try:
            before = tile_counts()["scanned"]
            golden_detect(workdir, "golden_detect_loops_inter", ["--inter"],
                          {"single": 3, "multi": 0}, show=tag == "dense")
            scanned = tile_counts()["scanned"] - before
            check((scanned > 0) == (tag == "tiled"), f"{tag}: {scanned} tiles scanned")
            if tag == "tiled":
                print(f"[golden-inter] tiles scanned: dense engine 0, tiled engine {scanned}, "
                      "the golden within its bounds again")
            rows[tag] = inter_quantify(workdir, tag)
        finally:
            contact_map.DENSE_LIMIT, tiled.DEFAULT_TILE = limit, tile
    dense, sparse = rows["dense"], rows["tiled"]
    check(len(dense) == len(sparse) == 4, "quantify --inter: row count")
    for a, b in zip(dense, sparse):
        check(all(a[c] == b[c] for c in ("chrom1", "start1", "chrom2", "start2",
                                          "bin1", "bin2")), "quantify --inter: rows")
        sa, sb = num(a["score"]), num(b["score"])
        check(np.isnan(sa) == np.isnan(sb), "quantify --inter: NaN pattern")
        check(np.isnan(sa) or abs(sa - sb) < 5e-5, f"quantify --inter: {sa} vs {sb}")
    print("[golden-inter] quantify --inter: 4/4 rows alike on both engines, scores "
          + json.dumps([r["score"] for r in dense]))


def inter_cut(source, cfg):
    """One trans map of the genome, preprocessed, cut to INTER_CUT bins a
    side: (CSR matrix, missing rows, missing columns, detectable bins)."""
    genome = HicGenome(source, inter=True, kernel_config=cfg, device=DEVICE)
    genome.normalize("auto")
    genome.make_sub_matrices()
    cm = next(s.contact_map for s in genome.sub_mats.itertuples() if s.chr1 != s.chr2)
    cm.create_mat()
    cut = cm.sparse[:INTER_CUT, :INTER_CUT].tocsr()
    det = [np.asarray(d)[np.asarray(d) < INTER_CUT] for d in cm.detectable_bins]
    cm.destroy_mat()
    missing = [missing_flags(d, INTER_CUT) for d in det]
    return cut, missing, det


def check_inter_cut(source):
    """An INTER_CUT x INTER_CUT cut of the chr1-chr2 map through the dense
    engine and the tiled engine on the card: corr within 2e-5 everywhere
    (the nonzero patterns compared too), then ``pattern_detector`` on the
    cut held dense and held sparse: the same calls, scores within 2e-5."""
    cfg = load_kernel_config("loops")
    kernel = np.asarray(cfg["kernels"][0])
    tol = cfg["max_perc_undetected"] / 100
    cut, (mr, mc), det = inter_cut(source, cfg)
    dense = torch.from_numpy(cut.toarray()).to(DEVICE)
    mask = make_missing_mask_dense(
        dense.shape, torch.from_numpy(mr).to(DEVICE), torch.from_numpy(mc).to(DEVICE))

    def by_dense():
        return normxcorr2_dense(dense, kernel, full=True, missing_mask=mask,
                                missing_tol=tol, pval=True)

    def by_tiles():
        return normxcorr2_sparse_tiled(cut, kernel, full=True, missing_vectors=(mr, mc),
                                       missing_tol=tol, pval=True, device=DEVICE)

    ref = by_dense()[0].cpu().numpy()
    got = by_tiles()[0].toarray()
    err = float(np.abs(ref - got).max())
    flips = int(((ref != 0) != (got != 0)).sum())
    t_dense, t_tiles = device_ms(by_dense, reps=3), device_ms(by_tiles, reps=3)
    print(f"[genome-inter] cut {INTER_CUT}x{INTER_CUT} of chr1-chr2 ({cut.nnz} pixels): "
          f"dense vs tiled corr max|d| {err:.3g}, nonzero pattern differs at {flips} "
          f"pixels; normxcorr2 with p-values, events: dense {t_dense:.1f} ms, "
          f"tiled {t_tiles:.1f} ms (COO, bucketing and CSR on the host included)")
    check(err < 2e-5, f"inter cut: dense and tiled corr differ by {err}")
    foci = pick_foci(ref, cfg["pearson"])[0]
    check(foci is not None, "inter cut: no focus")
    check(np.array_equal(foci, pick_foci(got, cfg["pearson"])[0]),
          "inter cut: foci differ between the engines")
    del dense, mask, ref, got
    maps = {}
    for form in ("dense", "sparse"):
        cm = ContactMap(None, [(0, INTER_CUT), (0, INTER_CUT)], device=DEVICE, name="cut",
                        detectable_bins=det, inter=True)
        if form == "dense":
            cm.dense_dev = torch.from_numpy(cut.toarray().astype(np.float64)).to(DEVICE)
        else:
            cm.sparse = cut
        maps[form] = cm
    # windows of a sparse trans map are mostly zeros, so every call would
    # fail the 10% zero rule: lifted here, the calls compare something
    relaxed = dict(cfg, max_perc_zero=100.0)
    calls = {f: pattern_detector(cm, relaxed, kernel, full=True)[0] for f, cm in maps.items()}
    a, b = calls["dense"], calls["sparse"]
    check(a is not None and b is not None, "inter cut: no call")
    same = a[["bin1", "bin2"]].equals(b[["bin1", "bin2"]])
    check(same and len(a["bin1"]) > 0,
          f"inter cut: calls differ ({len(a['bin1'])} vs {len(b['bin1'])})")
    d = float(np.abs(a["score"].to_numpy() - b["score"].to_numpy()).max())
    dp = float(np.abs(a["pvalue"].to_numpy() - b["pvalue"].to_numpy()).max())
    print(f"[genome-inter] cut: {len(foci)} foci identical on both engines; with the zero "
          f"rule lifted, {len(a['bin1'])} calls identical, score max|d| {d:.3g}, pvalue "
          f"max|d| {dp:.3g}")
    check(d < 2e-5, f"inter cut: scores differ by {d}")


def phase_genome_inter(workdir):
    """``detect --inter`` with loops on a synthetic 3 x 50,000-bin genome
    with trans contacts; then the dense-vs-tiled check on a cut."""
    t0 = time.perf_counter()
    source = ArraySource.from_synthetic(INTER_CHROMS, INTER_BINS, seed=0,
                                        binsize=BINSIZE, trans_density=TRANS_DENSITY)
    print(f"[genome-inter] synthetic genome {INTER_CHROMS} x {INTER_BINS} bins, trans "
          f"density {TRANS_DENSITY:g}: {source.nnz} pixels, generated and balanced in "
          f"{time.perf_counter() - t0:.1f} s")
    # under the bench's cache name: phase baseline-configs reads it for row 5c
    write_cool(source, str(bench_genome.genome_path(INTER_CHROMS, INTER_BINS, TRANS_DENSITY)),
               "genome-inter")
    args = parse_args(["detect", "--no-plotting", "--inter", "synthetic",
                       f"{workdir}/inter"], "")
    (table, _), seen = run_genome("detect --inter loops",
                                  lambda: detect(source, args, DEVICE), show="stages")
    tiles = tile_counts()  # run_genome resets the counters first
    peak = torch.cuda.max_memory_allocated()
    dense_map = 4 * INTER_BINS * INTER_BINS
    trans = table["chrom1"] != table["chrom2"]
    recall = planted_recall(source, table)
    scan = stage_seconds().get("tile scan", 0.0)
    pixels = tiles["scanned"] * tiled.DEFAULT_TILE ** 2
    print(f"[genome-inter] {len(table['bin1'])} calls, {int(trans.sum())} trans; recall "
          f"{recall:.4f} ({len(source.planted)} planted, +-2 bins); tiles "
          f"{json.dumps(tiles)} of {tiled.DEFAULT_TILE}, batches of "
          f"{tiled.TILE_BATCH}; tile scan {scan:.3f} s for {pixels:.4g} output pixels; "
          f"peak device memory {peak / 2**30:.3f} GiB, {100 * peak / dense_map:.1f}% of one "
          f"dense f32 trans map ({dense_map / 2**30:.2f} GiB)")
    check(seen == {"single": INTER_CHROMS, "multi": 0}, f"--inter launches {seen}")
    check(recall >= 0.95, f"--inter recall {recall} below 0.95")
    check(tiles["scanned"] > 0, "no tile scanned")
    check(tiles["scattered"] == tiles["scanned"],
          "a sparse trans tile took the dense conv2d numerator")
    check(peak < dense_map / 2, f"peak device memory {peak} near a dense trans map")
    check(all(np.isfinite(table["score"])) and all(np.isfinite(table["pvalue"])),
          "non-finite --inter scores")
    check_trans_fetch(source)
    check_inter_cut(source)


def check_trans_fetch(source):
    """Each trans pair's fetch through the native ``trans_coo_balanced``
    against its numpy fallback: the same triplets; host seconds of
    both, beside the run's ``io: trans fetch``."""
    names = source.chromnames
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    seconds = {"native": 0.0, "numpy": 0.0}
    fetched = {}
    for how in ("native", "numpy"):
        saved = host_native.trans_coo_balanced
        if how == "numpy":
            host_native.trans_coo_balanced = lambda *args: None
        try:
            for pair in pairs:
                t0 = time.perf_counter()
                out = source.trans_coo_raw(source.extent(pair[0]), source.extent(pair[1]),
                                           balance=True)
                seconds[how] += time.perf_counter() - t0
                fetched.setdefault(pair, []).append(out)
        finally:
            host_native.trans_coo_balanced = saved
    for pair, (a, b) in fetched.items():
        check(all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b)),
              f"trans fetch of {pair}: native and numpy differ")
    n = sum(len(a[0]) for a, _ in fetched.values())
    print(f"[genome-inter] trans fetch of the {len(pairs)} pairs ({n} pixels): native "
          f"{seconds['native']:.3f} s, numpy fallback {seconds['numpy']:.3f} s, the same "
          f"triplets; io: trans fetch of the detect run "
          f"{STAGES['detect --inter loops'].get('io: trans fetch', 0.0):.3f} s")


def source_fingerprint(source):
    """tests/test_golden_genome_scale.py:45-58 on a source's counts in cool
    pixel order (bin1, then bin2): the pixel count and the sum of every
    ``n // 4096``-th count, 4096 of them."""
    counts = source.count[np.lexsort((source.bin2, source.bin1))]
    sample = counts[:: max(len(counts) // 4096, 1)][:4096]
    return {"nnz": int(len(counts)), "checksum": int(np.asarray(sample, np.int64).sum())}


def compare_genome_golden(golden_path, prefix, table):
    """tests/test_golden_genome_scale.py:121-134: the same (bin1, bin2,
    kernel_id, iteration) calls and chrom/start columns; the score max|d|;
    and the log10 p max|d| twice: between the written p-values (10
    decimals in both files, as that test compares them), and between the
    run's unrounded p-values (``table``) and the interval of values the
    reference's written decimal stands for.  Returns (calls, score max|d|,
    text log10 p max|d| and its worst row, unrounded log10 p max|d|)."""
    import pandas as pd

    key = ["bin1", "bin2", "kernel_id", "iteration"]
    g = pd.read_csv(golden_path, sep="\t").sort_values(key).reset_index(drop=True)
    o = pd.read_csv(prefix + ".tsv", sep="\t").sort_values(key).reset_index(drop=True)
    exact = pd.DataFrame({k: table[k] for k in key + ["pvalue"]})
    exact = exact.sort_values(key).reset_index(drop=True)
    check(len(o) == len(g), f"{golden_path}: {len(o)} calls, the reference {len(g)}")
    for col in key + ["chrom1", "start1", "chrom2", "start2"]:
        check((g[col] == o[col]).all(), f"{golden_path}: column {col} differs")
    check(exact[key].equals(o[key]), f"{prefix}: the table and the file differ")

    def log10(p):
        return np.log10(np.maximum(p, 1e-300))

    text = np.abs(log10(g.pvalue) - log10(o.pvalue))
    worst = int(np.argmax(text))
    nearest = np.clip(exact.pvalue, g.pvalue - 5e-11, g.pvalue + 5e-11)
    unrounded = np.abs(log10(exact.pvalue) - log10(nearest))
    row = (f"bin1 {g.bin1[worst]}, bin2 {g.bin2[worst]}: written {g.pvalue[worst]:.10f} by the "
           f"reference, {o.pvalue[worst]:.10f} here, unrounded {exact.pvalue[worst]:.6g}")
    return (len(g), float(np.abs(g.score - o.score).max()), float(text.max()), row,
            float(unrounded.max()))


def phase_genome_golden(workdir):
    """The reference's own genome-scale calls (tests/data/golden_genome_
    {loops,borders}.tsv): the seed-0 3 x 50,000 genome of
    tools/make_synthetic_cool.py, its fingerprint checked, written as a
    ``.cool`` by the port's ``create_cool``; ``detect`` of the file at
    --norm auto with loops and with borders, held to the bounds of
    tests/test_golden_genome_scale.py."""
    t0 = time.perf_counter()
    source = ArraySource.from_synthetic(GOLDEN_CHROMS, GOLDEN_BINS, seed=0, binsize=BINSIZE)
    meta = json.loads(pathlib.Path("tests/data/golden_genome_meta.json").read_text())
    got = source_fingerprint(source)
    print(f"[genome-golden] synthetic genome {GOLDEN_CHROMS} x {GOLDEN_BINS} bins, seed 0: "
          f"generated and balanced in {time.perf_counter() - t0:.1f} s; fingerprint "
          f"{json.dumps(got)}, the goldens' {got == meta['fingerprint']}")
    check(got == meta["fingerprint"], "genome-golden: fingerprint differs")
    # under the bench's cache name: phase baseline-configs reads it for rows 4 and 5
    path = write_cool(source, str(bench_genome.genome_path(GOLDEN_CHROMS, GOLDEN_BINS)),
                      "genome-golden")
    del source
    for name, flags, expect in (("loops", [], {"single": GOLDEN_CHROMS, "multi": 0}),
                                ("borders", ["--pattern", "borders"],
                                 {"single": 0, "multi": GOLDEN_CHROMS})):
        prefix = f"{workdir}/genome_golden_{name}"
        args = parse_args(["detect", "--no-plotting", "--norm", "auto", *flags, path,
                           prefix], "")

        def run_detect():
            with contextlib.redirect_stdout(io.StringIO()):
                return detect(open_contacts(path), args, DEVICE)

        (table, _), seen = run_genome(f"golden {name}", run_detect, tag="genome-golden",
                                      show=None)
        n_calls, d_score, d_text, _, d_logp = compare_genome_golden(
            f"tests/data/golden_genome_{name}.tsv", prefix, table)
        print(f"[genome-golden] {name}: {n_calls}/{n_calls} reference calls identical; score "
              f"max|d| {d_score:.3g} (5e-5); log10 p max|d| {d_logp:.3g} (1e-3) unrounded, "
              f"{d_text:.3g} written; {seen}, wall {WALLS[f'golden {name}']:.2f} s")
        check(d_score < 5e-5 and d_logp < 1e-3, f"genome-golden {name}: outside the bounds")
        check(seen == expect, f"genome-golden {name}: launches {seen}")


def write_cool(source, path, tag):
    """``source`` written as a ``.cool`` by the port's ``create_cool``
    (through ``bench.genome.write_genome``: its planted loops beside it as
    ``.truth.bed2d``), after checking that the directory can hold it (the
    phase fails if it cannot); the path."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    need = source.nnz * (source.bin1.itemsize + source.bin2.itemsize + source.count.itemsize)
    need += 64 * source.n_bins + (1 << 20)
    free = shutil.disk_usage(os.path.dirname(path)).free
    check(free > need, f"{tag}: {free} bytes free, the .cool file needs {need}")
    t0 = time.perf_counter()
    bench_genome.write_genome(source, path)
    seconds = time.perf_counter() - t0
    size = os.path.getsize(path)
    print(f"[{tag}] create_cool wrote {os.path.basename(path)}: {source.nnz} pixels, {size} bytes in "
          f"{seconds:.2f} s ({size / seconds / 1e9:.2f} GB/s; {free / 1e9:.2f} GB were free)")
    return path


def evict(path):
    """Write ``path``'s pages to disk and ask the kernel to drop them from
    the page cache (POSIX_FADV_DONTNEED), so the next read comes from the
    disk as far as the kernel honours the advice."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def phase_cool_genome(source, workdir):
    """The 13 x 48,000 genome written as a ``.cool`` by the port's
    ``create_cool``, then ``detect`` with loops from the file (pages
    dropped first, then again from the page cache, then through the f32
    path), ``quantify`` of the planted loops from it, and ``detect`` once
    more from the in-memory source: each table and window file byte for
    byte phase 5's in-memory run; ``io: fetch+scatter`` and the wall of
    each, side by side.  The file is the bench's cached genome
    (``bench.genome.genome_path``), which phase ``bench`` reads next and
    deletes.  Returns the bytes read from each column by run
    (``phase_cooler_genome`` prints them beside its own)."""
    phase5 = {name: outputs(f"{workdir}/{name}") for name in ("genome", "quantify")}
    path = write_cool(source, str(bench_genome.genome_path(GENOME_CHROMS, GENOME_BINS)),
                      "cool-genome")
    n_chroms = len(source.chromnames)
    runs = {}
    read = {}
    for tag, quant in (("cool, pages dropped", False), ("cool, page cache", False),
                       ("cool, page cache, f32 path", False), ("cool, page cache", True),
                       ("memory", False)):
        if tag == "cool, pages dropped":
            evict(path)
        prefix = f"{workdir}/cool_genome_{len(runs) + 1}"
        contacts = path if tag.startswith("cool") else "synthetic"
        if quant:
            argv = ["quantify", "--no-plotting", f"{workdir}/planted.bed2", contacts, prefix]
        else:
            argv = ["detect", "--no-plotting", contacts, prefix]
        args = parse_args(argv, "")
        f32 = tag.endswith("f32 path")

        def run_main():
            opened = open_contacts(path) if tag.startswith("cool") else source
            with contextlib.redirect_stdout(io.StringIO()):
                return (quantify if quant else detect)(opened, args, DEVICE)

        name = f"{'quantify planted loops' if quant else 'detect loops'} from {tag}"
        runs[f"{'quantify' if quant else 'loops'}, {tag}"] = name
        with packing(None if f32 else contact_map.COUNT_PACKING), \
                counting_reads(read.setdefault(name, {})):
            _, seen = run_genome(name, run_main, tag="cool-genome", show=None)
        band_uploads(source, "cool-genome", modes=("f32",) if f32 else COUNT_MODES)
        stored = phase5["quantify" if quant else "genome"]
        check(outputs(prefix) == stored and stored,
              f"cool-genome: the {tag} table or windows differ from phase 5's")
        check(seen == {"single": 0 if quant else n_chroms, "multi": 0},
              f"cool-genome: launches {seen}")
        if tag.startswith("cool"):
            # the count path reads bin2_id and count, never bin1_id
            check(("pixels/bin1_id" in read[name]) == f32,
                  f"cool-genome: {name} read {sorted(read[name])}")
    print(f"[cool-genome] phase 5's tables and windows, {n_chroms} single launches a loops run; "
          f"{nvidia_smi('name,power.limit')}")
    shown, entries = "", []
    for tag, name in runs.items():
        got = bytes_read(read.get(name, {}))
        entries.append(f"{tag}: {STAGES[name].get('io: fetch+scatter', 0.0):.3f}, "
                       f"{STAGES[name].get('io: upload', 0.0):.3f}, {WALLS[name]:.2f}"
                       + (f" (read {got})" if got and got != shown else ""))
        shown = got or shown
    print("[cool-genome] io: fetch+scatter, io: upload, wall s: " + "; ".join(entries[:2]))
    for pair in range(2, len(entries), 2):
        print("[cool-genome] " + "; ".join(entries[pair:pair + 2]))
    return read


# tests/test_bench_contract.py:53-66's keys and the three the port adds
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "wall_s", "walls_s", "baseline",
              "baseline_slice_s", "warm_compile_load_s", "recall_planted_loops", "stage_s",
              "link", "compute", "device", "peak_memory_bytes", "idle_share")
BASELINES = ("reference chromosight sparse engine (own code), engine-only slice",
             "reference-formulation reimplementation")


def phase_bench(workdir):
    """``python3 bench_torch.py`` as a user runs it, in a process of its
    own, on the ``.cool`` phase ``cool-genome`` wrote under the bench's
    cache name: one stdout line with the contract keys, the card's name,
    recall >= 0.95, 13 band launches a timed pass, its calls byte for byte
    ``cool-genome``'s loops table; then the quantify bench in this process
    (the planted loops scored as in phase 5).  The genome file is deleted
    afterwards."""
    path = bench_genome.genome_path(GENOME_CHROMS, GENOME_BINS)
    try:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "bench_torch.py"], capture_output=True, text=True,
                             timeout=900)
        seconds = time.perf_counter() - t0
        sys.stderr.write(res.stderr[-3000:])
        check(res.returncode == 0, f"bench: bench_torch.py exited {res.returncode}")
        lines = res.stdout.splitlines()
        check(len(lines) == 1, f"bench: {len(lines)} stdout lines")
        rec = json.loads(lines[0])
        check(all(key in rec for key in BENCH_KEYS), f"bench: keys {sorted(rec)}")
        card = rec["device"]
        smi = nvidia_smi("name,power.limit")
        check(f"{card['name']}, {card['power_limit']}" == smi
              and card["kind"] == torch.cuda.get_device_name(0), f"bench: device {card}")
        check(rec["baseline"] in BASELINES, f"bench: baseline {rec['baseline']}")
        check(rec["recall_planted_loops"] >= 0.95, f"bench: recall {rec['recall_planted_loops']}")
        launched = rec["compute"]["band_launches"]
        check(launched == [GENOME_CHROMS] * len(rec["walls_s"]), f"bench: launches {launched}")
        table = pathlib.Path(f"{workdir}/cool_genome_1.tsv").read_bytes()
        calls = rec["calls"]
        check(calls["sha256"] == hashlib.sha256(table).hexdigest(),
              "bench: its table differs from cool-genome's")
        link, comp = rec["link"], rec["compute"]
        print(f"[bench] bench_torch.py ({seconds:.1f} s): wall {rec['wall_s']} s of "
              f"{rec['walls_s']}, {rec['value']:.4g} windows/s, vs_baseline {rec['vs_baseline']} "
              f"({rec['baseline'].split()[0]}, {rec['baseline_slice_s']} s); warm "
              f"{rec['warm_compile_load_s']} s; recall {rec['recall_planted_loops']:.4f}; "
              f"{calls['n']} calls = cool-genome's; launches {launched}; idle "
              f"{rec['idle_share']}; peak {rec['peak_memory_bytes'] / 2**30:.3f} GiB; link "
              f"{link['up_MBps']} / {link['down_MBps']} MB/s, rtt {link['rtt_ms']} ms, "
              f"{link['attributable_s']} s; mfu {comp['mfu_detect_stage']} / {comp['mfu_e2e']}")
        top = sorted(rec["stage_s"].items(), key=lambda kv: -kv[1])[:6]
        print("[bench] stages (s): " + ", ".join(f"{k} {v}" for k, v in top)
              + f"; cool-genome's page-cache loops wall "
              f"{WALLS['detect loops from cool, page cache']:.2f} s")

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            bench_quantify.main()
        rec = json.loads(out.getvalue())
        import pandas as pd

        phase5 = pd.read_csv(f"{workdir}/quantify.tsv", sep="\t")
        scored = int(phase5["score"].notna().sum())
        print(f"[bench] quantify bench: {rec['n_coords']} coordinates, {rec['n_scored']} scored "
              f"(phase 5: {scored}), median {rec['median_score']}; walls {rec['walls_s']} s")
        check(rec["n_coords"] == len(phase5) and rec["n_scored"] == scored,
              "bench: the quantify bench differs from phase 5")
    finally:
        for done in (path, bench_genome.truth_path(path)):
            if os.path.exists(done):
                os.unlink(done)


# the patterns of BASELINE_RESULTS.md:7-14, row by row, but for row 5c:
# the port calls 159 there, the JAX package's 157 is its round-3 run's
# (ROADMAP.md §3)
BASELINE_COUNTS = (85, 53, 57, 55, 68, 159, 159, 90)


def phase_baseline_configs(workdir):
    """The eight BASELINE rows through ``chromosight_torch.bench.
    baseline_configs`` on the card: the example rows, and rows 4, 5 and 5c
    on the 3 x 50,000 genomes phases ``genome-golden`` and ``genome-inter``
    wrote under the bench's cache names; every row ``ok`` with the JAX
    package's pattern counts.  Then the ``--inter`` bench on row 5c's file:
    its calls, twice."""
    genome = bench_genome.genome_path(GOLDEN_CHROMS, GOLDEN_BINS)
    trans = bench_genome.genome_path(INTER_CHROMS, INTER_BINS, TRANS_DENSITY)
    rowdir = pathlib.Path(workdir) / "rows"
    rowdir.mkdir()
    rows = bench_rows.run_configs(str(rowdir), str(genome), str(trans), DEVICE)
    counts = tuple(r["patterns"] for r in rows)
    print(f"[baseline-configs] {nvidia_smi('name,power.limit')}; row: patterns, wall s: "
          + "; ".join(f"{r['name'].split()[0]} {r['patterns']}, {r['wall_s']:.2f}"
                      + ("" if r["status"] == "ok" else f" {r['status']}") for r in rows))
    check(all(r["status"] == "ok" for r in rows), "baseline-configs: a row failed")
    check(counts == BASELINE_COUNTS, f"baseline-configs: patterns {counts}")
    # the trans genome's cis contacts and cis-only weights are the golden
    # genome's: row 5c's calls are the reference's own loops calls on it
    import pandas as pd

    key = ["chrom1", "start1", "chrom2", "start2"]
    inter_calls = pd.read_csv(rows[6]["prefix"] + ".tsv", sep="\t")[key]
    golden = pd.read_csv("tests/data/golden_genome_loops.tsv", sep="\t")[key]
    same = inter_calls.sort_values(key).reset_index(drop=True).equals(
        golden.sort_values(key).reset_index(drop=True))
    check(same, "baseline-configs: row 5c's calls differ from the reference's genome calls")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        records = bench_inter.main([str(trans), "2"])
    check([json.loads(line) for line in out.getvalue().splitlines()] == records,
          "inter bench: its lines")
    want = rows[6]["patterns"]
    print(f"[baseline-configs] row 5c's {len(inter_calls)} calls = golden_genome_loops.tsv's "
          f"{len(golden)}: {same}; --inter bench on its file: calls "
          f"{[r['calls'] for r in records]}, walls {[r['wall_s'] for r in records]} s, tile scan "
          f"{[r['stage_s'].get('tile scan') for r in records]} s")
    check(all(r["rc"] == 0 and r["calls"] == want for r in records),
          f"inter bench: {records}")


def bytes_read(totals):
    """The bytes read from each pixel column (``counting_reads``), short."""
    return ", ".join(f"{k.split('/')[1]} {v}" for k, v in sorted(totals.items())
                     if k.startswith("pixels/"))


def phase_cooler_genome(source, workdir, contiguous_read):
    """Phase 5's genome (not cut) written by the port in cooler's own
    layout as ``genome.mcool::/resolutions/5000``: int64 ids and int32
    counts, every dataset chunked (6,094 rows for the int64 pixel columns,
    12,188 for the int32 one: h5py's chunks for columns created at
    ``COOLER_PIXEL_ROWS``), shuffle + gzip 6, ``bins/chrom`` an enum; the
    free space checked first, the write's seconds, the file's size and
    each pixel column's chunk B-tree depth printed.  Then ``detect`` loops
    and ``quantify`` of the planted loops from it, pages dropped and from
    the page cache: tables and windows byte for byte phase 5's, 13 single
    launches for loops and none for quantify, ``io: fetch+scatter``, ``io:
    upload``, the wall and the bytes read by column beside the
    contiguous ``.cool``'s runs of phase ``cool-genome``
    (``contiguous_read``).  The file is deleted afterwards."""
    tag = "cooler-genome"
    os.makedirs(f"{workdir}/cooler", exist_ok=True)
    path = f"{workdir}/cooler/genome.mcool"
    uri = f"{path}::/resolutions/5000"
    raw = source.nnz * (8 + 8 + source.count.itemsize)
    need = raw + 64 * source.n_bins + (1 << 20)
    free = shutil.disk_usage(os.path.dirname(path)).free
    check(free > need, f"{tag}: {free} bytes free, the .mcool file may need {need}")
    card = nvidia_smi("name,power.limit")
    n_chroms = len(source.chromnames)
    phase5 = {name: outputs(f"{workdir}/{name}") for name in ("genome", "quantify")}
    try:
        t0 = time.perf_counter()
        write_cooler_layout(path, bins_frame(source), {"bin1_id": source.bin1, "bin2_id":
                            source.bin2, "count": source.count.astype(np.int32, copy=False)},
                            group="/resolutions/5000", pixel_rows=COOLER_PIXEL_ROWS)
        seconds = time.perf_counter() - t0
        columns = {}
        with hdf5.File(path) as f:
            for col in ("bin1_id", "bin2_id", "count"):
                d = f[f"resolutions/5000/pixels/{col}"]
                level = f._btree(d._btree_addr, 24)[0]
                columns[col] = (str(d.dtype), d._chunk_shape[0], len(d._chunk_index()[1]), level)
            enum = f["resolutions/5000/bins/chrom"].dtype
        size = os.path.getsize(path)
        print(f"[{tag}] write_cooler_layout, {short_path(uri)}: {source.nnz} pixels, {size} "
              f"bytes in {seconds:.2f} s ({hdf5.THREADS} threads); pixel "
              f"columns (dtype, chunk rows, chunks, chunk B-tree depth): " + "; ".join(
                  f"{col} {' '.join(map(str, v))}" for col, v in columns.items()))
        check([v[:2] for v in columns.values()] == [("int64", 6094), ("int64", 6094),
                                                     ("int32", 12188)],
              f"{tag}: pixel columns {columns}")
        check(columns["bin2_id"][3] == 2, f"{tag}: bin2_id's chunk B-tree depth "
                                          f"{columns['bin2_id'][3]}, 2 expected")
        check(enum == np.int32, f"{tag}: bins/chrom read as {enum}")
        runs, read = {}, {}
        for kind, contiguous in (("loops", "detect loops from cool, "),
                                 ("quantify", "quantify planted loops from cool, page cache")):
            stored = phase5["genome" if kind == "loops" else "quantify"]
            for cache in ("pages dropped", "page cache"):
                if cache == "pages dropped":
                    evict(path)
                name = f"{kind} from .mcool, {cache}"
                prefix = f"{workdir}/cooler_{kind}_{len(runs)}"
                if kind == "loops":
                    argv = ["detect", "--no-plotting", uri, prefix]
                else:
                    argv = ["quantify", "--no-plotting", f"{workdir}/planted.bed2", uri, prefix]
                args = parse_args(argv, "")

                def run_main():
                    opened = open_contacts(uri)
                    with contextlib.redirect_stdout(io.StringIO()):
                        return (detect if kind == "loops" else quantify)(opened, args, DEVICE)

                with counting_reads(read.setdefault(name, {})):
                    _, seen = run_genome(name, run_main, tag=tag, show=None)
                band_uploads(source, tag)
                runs[name] = contiguous + (cache if kind == "loops" else "")
                check(outputs(prefix) == stored and stored,
                      f"{tag}: the {name} table or windows differ from phase 5's")
                check(seen == {"single": n_chroms if kind == "loops" else 0, "multi": 0},
                      f"{tag}: {name} launches {seen}")
                check("pixels/bin1_id" not in read[name], f"{tag}: {name} read bin1_id")
    finally:
        if os.path.exists(path):
            os.unlink(path)
    print(f"[{tag}] phase 5's tables and windows, {n_chroms} single launches a loops run; "
          f"{card}; beside cool-genome's runs, which read "
          f"{bytes_read(contiguous_read[next(iter(runs.values()))])}:")
    shown, entries = None, []
    for name, contiguous in runs.items():
        a, b = STAGES[name], STAGES[contiguous]
        got = bytes_read(read[name])
        entries.append(f"{name.replace(' from .mcool', '')}: " + ", ".join(
            f"{a.get(stage, 0.0):.3f} ({b.get(stage, 0.0):.3f})"
            for stage in ("io: fetch+scatter", "io: upload"))
            + f", {WALLS[name]:.2f} ({WALLS[contiguous]:.2f})"
            + ("" if got == shown else f"; read {got}"))
        shown = got
    print(f"[{tag}] fetch+scatter, upload, wall s: " + "; ".join(entries[:2]))
    print(f"[{tag}] " + "; ".join(entries[2:]))


def phase_latest_genome(source, workdir):
    """Phase 5's genome (not cut) written by the port without weights in
    HDF5's newest layout (``write_cooler_layout(..., libver="latest")``:
    superblock 3, extensible-array pixel columns, int64 ids, shuffle +
    gzip 6, ``bins/chrom`` an enum) with five more bins columns named as
    normalisation vectors, so that bins holds 8 links; the free space
    checked first, the write's seconds, the file's size and the structures
    walked printed.  Then (a) ``detect`` loops at ``--norm auto``: ICE on
    the host, its weights stored (the ninth link turns bins dense); (b)
    ``detect`` loops again, the weights read back; (c) ``--norm force``,
    the weight link replaced in the dense group; (d) ``quantify`` of the
    planted loops.  Weights bit for bit the genome's (phase
    ``surface-genome``'s weightless run holds them), tables and windows
    byte for byte phase 5's, 13 single launches a loops run; ``io:
    fetch+scatter``, ``io: upload`` and the wall beside ``cooler-genome``'s.
    The file is deleted afterwards."""
    tag = "latest-genome"
    os.makedirs(f"{workdir}/latest", exist_ok=True)
    path = f"{workdir}/latest/genome.cool"
    raw = source.nnz * (8 + 8 + source.count.itemsize)
    need = raw + 64 * source.n_bins + (1 << 20)
    free = shutil.disk_usage(os.path.dirname(path)).free
    check(free > need, f"{tag}: {free} bytes free, the file may need {need}")
    n_chroms = len(source.chromnames)
    phase5 = {name: outputs(f"{workdir}/{name}") for name in ("genome", "quantify")}
    rng = np.random.RandomState(0)
    norms = {name: rng.rand(source.n_bins) for name in NORM_COLUMNS}
    bins = bins_frame(source).drop(columns="weight")
    try:
        t0 = time.perf_counter()
        write_cooler_layout(path, bins, {"bin1_id": source.bin1, "bin2_id": source.bin2,
                                         "count": source.count.astype(np.int32, copy=False)},
                            pixel_rows=COOLER_PIXEL_ROWS, columns=norms, libver="latest")
        seconds = time.perf_counter() - t0
        with hdf5.File(path) as f:
            kinds = {c: f[f"pixels/{c}"]._index_type for c in ("bin1_id", "bin2_id", "count")}
            links, dense = len(f["bins"].keys()), f["bins"].dense
            superblock = f._version
        print(f"[{tag}] write_cooler_layout(libver=\"latest\"): {source.nnz} "
              f"pixels, {os.path.getsize(path)} bytes in {seconds:.2f} s; "
              f"superblock {superblock}, pixel chunk indexes {sorted(set(kinds.values()))}, "
              f"bins {links} links (dense {dense})")
        check(superblock == 3 and set(kinds.values()) == {hdf5.EXTENSIBLE_ARRAY}
              and links == 8 and not dense, f"{tag}: the file's layout")
        runs, weights = {}, {}
        for run, argv_head, stored in (
                ("a", ["detect", "--no-plotting"], "genome"),
                ("b", ["detect", "--no-plotting"], "genome"),
                ("c", ["detect", "--no-plotting", "--norm", "force"], "genome"),
                ("d", ["quantify", "--no-plotting", f"{workdir}/planted.bed2"], "quantify")):
            prefix = f"{workdir}/latest_{run}"
            args = parse_args([*argv_head, path, prefix], "")
            opened = []

            def run_main():
                opened.append(open_contacts(path))
                with contextlib.redirect_stdout(io.StringIO()):
                    return (quantify if run == "d" else detect)(opened[0], args, DEVICE)

            name = f"({run}) {'quantify' if run == 'd' else 'loops'} from the newest layout"
            _, seen = run_genome(name, run_main, tag=tag, show=None)
            runs[run] = (name, seen, dict(opened[0]._file.walked))
            check(outputs(prefix) == phase5[stored] and phase5[stored],
                  f"{tag}: run ({run}) tables or windows differ from phase 5's")
            check(seen == {"single": 0 if run == "d" else n_chroms, "multi": 0},
                  f"{tag}: run ({run}) launches {seen}")
            ice = STAGES[name].get("balance: ICE")
            check((ice is not None) == (run in "ac"), f"{tag}: run ({run}) ICE {ice}")
            weights[run] = CoolFile(path).weights
            check(weights[run].tobytes() == source.weights.tobytes(),
                  f"{tag}: run ({run}) weights differ from the genome's")
            with hdf5.File(path) as f:
                check(f["bins"].dense and len(f["bins"].keys()) == 9,
                      f"{tag}: bins after run ({run})")
    finally:
        if os.path.exists(path):
            os.unlink(path)
    walked = runs["b"][2]
    print(f"[{tag}] (a) ICE at --norm auto, (b) loops, (c) --norm force, (d) quantify: "
          f"weights bit for bit the genome's, tables byte for byte phase 5's, {n_chroms} "
          f"single launches a loops run; (b) walked " + ", ".join(
              f"{k} {walked.get(k, 0)}" for k in ("FRHP", "BTHD type 5", "EAHD", "EASB",
                                                   "EADB")))
    lines = []
    for run, (name, _, _) in runs.items():
        other = f"{'quantify' if run == 'd' else 'loops'} from .mcool, page cache"
        a, b = STAGES[name], STAGES.get(other, {})
        lines.append(f"({run}) " + ", ".join(
            f"{stage.split(' ')[-1]} {a.get(stage, 0.0):.3f}" + (
                "" if stage.endswith("ICE") else f" ({b.get(stage, 0.0):.3f})")
            for stage in ("balance: ICE", "io: fetch+scatter"))
            + f", wall {WALLS[name]:.2f} ({WALLS.get(other, 0.0):.2f})")
    print(f"[{tag}] s, in brackets cooler-genome's page-cache run: " + "; ".join(lines))


def phase_userblock_genome(source, workdir):
    """Phase 5's genome (not cut) written by the port without weights in
    cooler's layout (superblock 0, int64 ids, shuffle + gzip 6, an enum
    ``bins/chrom``) after a 512-byte user block that a text header fills,
    with 4-byte offsets and lengths (``write_cooler_layout(...,
    userblock=512, sizes=(4, 4))``); the free space checked first, the
    write's seconds and the file's size printed.  Then, through
    ``cmd_detect`` and ``cmd_quantify``: (a) ``detect`` loops at ``--norm
    auto``, ICE on the host storing the weights into the file; (b) loops
    again, the weights read back; (c) ``--norm force``, the weight link
    replaced; (d) ``quantify`` of the planted loops.  Weights bit for bit
    the genome's (phase ``surface-genome``'s weightless run holds them),
    tables and windows byte for byte phase 5's, 13 single launches a loops
    run, the user block's bytes unchanged at the end; ``balance: ICE``,
    ``io: fetch+scatter`` and the wall of each run beside
    ``latest-genome``'s.  The file is deleted afterwards."""
    tag = "userblock-genome"
    os.makedirs(f"{workdir}/userblock", exist_ok=True)
    path = f"{workdir}/userblock/genome.cool"
    raw = source.nnz * (8 + 8 + source.count.itemsize)
    need = raw + 64 * source.n_bins + (1 << 20)
    free = shutil.disk_usage(os.path.dirname(path)).free
    check(free > need, f"{tag}: {free} bytes free, the file may need {need}")
    card = nvidia_smi("name,power.limit")
    n_chroms = len(source.chromnames)
    phase5 = {name: outputs(f"{workdir}/{name}") for name in ("genome", "quantify")}
    header = b"# chromosight chip_smoke: the 13 x 48,000 synthetic genome at 5 kb\n"
    try:
        t0 = time.perf_counter()
        write_cooler_layout(path, bins_frame(source).drop(columns="weight"),
                            {"bin1_id": source.bin1, "bin2_id": source.bin2,
                             "count": source.count.astype(np.int32, copy=False)},
                            pixel_rows=COOLER_PIXEL_ROWS, userblock=512, sizes=(4, 4))
        seconds = time.perf_counter() - t0
        with open(path, "r+b") as handle:
            handle.write(header)
        block = pathlib.Path(path).read_bytes()[:512]
        with hdf5.File(path) as f:
            layout = (f._version, f._base, f._so, f._sl, "weight" in f["bins"])
        check(layout == (0, 512, 4, 4, False), f"{tag}: superblock, base, sizes {layout}")
        print(f"[{tag}] write_cooler_layout(userblock=512, sizes=(4, 4)): {source.nnz} pixels, "
              f"{os.path.getsize(path)} bytes in {seconds:.2f} s; superblock 0, no weights; "
              f"{card}")
        lines = []
        for run, head, stored in (
                ("a", ["detect", "--no-plotting"], "genome"),
                ("b", ["detect", "--no-plotting"], "genome"),
                ("c", ["detect", "--no-plotting", "--norm", "force"], "genome"),
                ("d", ["quantify", "--no-plotting", f"{workdir}/planted.bed2"], "quantify")):
            prefix = f"{workdir}/userblock_{run}"
            args = parse_args([*head, path, prefix], "")
            command = cli.cmd_quantify if run == "d" else cli.cmd_detect

            def run_main():
                with contextlib.redirect_stdout(io.StringIO()):
                    return command(args, DEVICE)

            kind = "quantify" if run == "d" else "loops"
            name = f"({run}) {kind} from the user-block file"
            _, seen = run_genome(name, run_main, tag=tag, show=None)
            check(outputs(prefix) == phase5[stored] and phase5[stored],
                  f"{tag}: run ({run}) tables or windows differ from phase 5's")
            check(seen == {"single": 0 if run == "d" else n_chroms, "multi": 0},
                  f"{tag}: run ({run}) launches {seen}")
            ice = STAGES[name].get("balance: ICE")
            check((ice is not None) == (run in "ac"), f"{tag}: run ({run}) ICE {ice}")
            check(CoolFile(path).weights.tobytes() == source.weights.tobytes(),
                  f"{tag}: run ({run}) weights differ from the genome's")
            other = f"({run}) {kind} from the newest layout"
            a, b = STAGES[name], STAGES.get(other, {})
            lines.append(f"({run}) {kind}: " + ", ".join(
                f"{stage.split(' ')[-1]} {a.get(stage, 0.0):.3f} ({b.get(stage, 0.0):.3f})"
                for stage in ("balance: ICE", "io: fetch+scatter") if stage in a)
                + f", wall {WALLS[name]:.2f} ({WALLS.get(other, 0.0):.2f}) s")
        check(pathlib.Path(path).read_bytes()[:512] == block, f"{tag}: the user block changed")
    finally:
        if os.path.exists(path):
            os.unlink(path)
    print(f"[{tag}] the genome's weights, phase 5's tables, {n_chroms} launches a loops run, "
          "the user block unchanged; s, in brackets latest-genome's:")
    for pair in range(0, len(lines), 2):
        print(f"[{tag}] " + "; ".join(lines[pair:pair + 2]))


def phase_szip_genome(source, workdir):
    """Phase 5's genome (not cut) written by the port in cooler's layout
    with szip (``write_cooler_layout(..., compression="szip")``: shuffle
    + szip ('nn', 8) on every column HDF5 takes szip for, int64 ids,
    ``bins/chrom`` an enum) as ``genome.mcool::/resolutions/5000``; the
    free space checked first, the write's seconds and bytes printed.  Then
    ``detect`` loops with the file's pages dropped and from the page
    cache, and ``quantify`` of the planted loops: tables and windows byte
    for byte phase 5's, 13 single launches a loops run and none a
    quantify run, szip chunks walked; ``io: fetch+scatter``, ``io:
    upload`` and the wall beside ``cooler-genome``'s runs, on one line.
    The file is deleted afterwards."""
    tag = "szip-genome"
    os.makedirs(f"{workdir}/szip", exist_ok=True)
    path = f"{workdir}/szip/genome.mcool"
    uri = f"{path}::/resolutions/5000"
    # a chunk szip does not shrink is stored as it is: the raw bytes at most
    raw = source.nnz * (8 + 8 + 4)
    need = raw + 64 * source.n_bins + (1 << 20)
    free = shutil.disk_usage(os.path.dirname(path)).free
    check(free > need, f"{tag}: {free} bytes free, the file may need {need}")
    card = nvidia_smi("name,power.limit")
    n_chroms = len(source.chromnames)
    phase5 = {name: outputs(f"{workdir}/{name}") for name in ("genome", "quantify")}
    entries, chunks = [], set()
    try:
        t0 = time.perf_counter()
        write_cooler_layout(path, bins_frame(source), {"bin1_id": source.bin1, "bin2_id":
                            source.bin2, "count": source.count.astype(np.int32, copy=False)},
                            group="/resolutions/5000", pixel_rows=COOLER_PIXEL_ROWS,
                            compression="szip")
        seconds = time.perf_counter() - t0
        with hdf5.File(path) as f:
            filters = {c: f[f"resolutions/5000/pixels/{c}"]._filters
                       for c in ("bin1_id", "bin2_id", "count")}
        size = os.path.getsize(path)
        print(f"[{tag}] wrote {size} bytes in {seconds:.2f} s ({hdf5.THREADS} threads; {card}); "
              "shuffle + szip (169, 8, 64 / 32, 1024) pixel columns; in brackets below "
              "cooler-genome's run in this call")
        check(filters["bin2_id"] == [(hdf5.SHUFFLE, (8,)), (hdf5.SZIP, (169, 8, 64, 1024))]
              and filters["count"] == [(hdf5.SHUFFLE, (4,)), (hdf5.SZIP, (169, 8, 32, 1024))],
              f"{tag}: pixel filters {filters}")
        for kind, cache in (("loops", "pages dropped"), ("loops", "page cache"),
                            ("quantify", "page cache")):
            if cache == "pages dropped":
                evict(path)
            name = f"{kind} from szip .mcool, {cache}"
            prefix = f"{workdir}/szip_{kind}_{cache.split()[0]}"
            if kind == "loops":
                argv = ["detect", "--no-plotting", uri, prefix]
            else:
                argv = ["quantify", "--no-plotting", f"{workdir}/planted.bed2", uri, prefix]
            args = parse_args(argv, "")
            opened = []

            def run_main():
                opened.append(open_contacts(uri))
                with contextlib.redirect_stdout(io.StringIO()):
                    return (detect if kind == "loops" else quantify)(opened[0], args, DEVICE)

            _, seen = run_genome(name, run_main, tag=tag, show=None)
            band_uploads(source, tag)
            walked = opened[0]._file.walked["szip chunk"]
            stored = phase5["genome" if kind == "loops" else "quantify"]
            check(outputs(prefix) == stored and stored,
                  f"{tag}: the {name} table or windows differ from phase 5's")
            check(seen == {"single": n_chroms if kind == "loops" else 0, "multi": 0},
                  f"{tag}: {name} launches {seen}")
            check(walked > 0, f"{tag}: {name} decoded no szip chunk")
            other = f"{kind} from .mcool, {cache}"
            a, b = STAGES[name], STAGES.get(other, {})
            entries.append(f"{kind}, {cache}: " + ", ".join(
                f"{a.get(stage, 0.0):.3f} ({b.get(stage, 0.0):.3f})"
                for stage in ("io: fetch+scatter", "io: upload"))
                + f", {WALLS[name]:.2f} ({WALLS.get(other, 0.0):.2f})")
            chunks.add(walked)
    finally:
        if os.path.exists(path):
            os.unlink(path)
    print(f"[{tag}] phase 5's tables, {n_chroms} single launches a loops run, szip chunks "
          f"{sorted(chunks)}; fetch+scatter, upload, wall s: " + "; ".join(entries))


def phase_instruments(source, workdir):
    """The port's instruments (chromosight_torch.observability) on the
    genome loops run (13 x 48,000 bins): the compute accounting per program
    family, the link bytes, the card's peaks and each family's FLOP/s over
    its stage; 13 band dispatches, the uploads equal to the packed bands'
    bytes worked out from each map's mode, exceptions and size, downloads;
    then a torch.profiler trace (CHROMOSIGHT_TPU_PROFILE) of one chromosome
    that names the band kernel, and the exit report of a command-line
    process with CHROMOSIGHT_TPU_TIMINGS=1."""
    cfg = load_kernel_config("loops")
    args = parse_args(["detect", "--no-plotting", "synthetic", f"{workdir}/instr"], "")

    def run_detect():
        with contextlib.redirect_stdout(io.StringIO()):
            return detect(source, args, DEVICE)

    run_genome("instruments: detect loops", run_detect, tag="instruments")
    compute = observability.compute_snapshot()
    stages, _, link = observability.snapshot()
    peak_flops, peak_bytes, label = observability.device_peaks()
    print(f"[instruments] device_peaks(): {peak_flops} FLOP/s, {peak_bytes} bytes/s, {label}; "
          f"link bytes {json.dumps(link)}")
    family_stage = {"band_normxcorr": "correlate", "band_preprocess": "preprocess"}
    for name, rec in sorted(compute.items()):
        seconds = stages.get(family_stage.get(name, ""), 0.0)
        rate = rec["flops"] / seconds if seconds else None
        share = "not measured" if rate is None or not peak_flops else f"{100 * rate / peak_flops:.2f}%"
        print(f"[instruments] {name}: {rec['flops']:.4g} FLOP, {rec['hbm_min_bytes']:.4g} / "
              f"{rec['hbm_unfused_bytes']:.4g} bytes, {rec['dispatches']} dispatches; "
              f"{family_stage.get(name)} {seconds:.4f} s, "
              f"{'not measured' if rate is None else f'{rate:.4g}'} FLOP/s, {share} of the "
              f"peak")
    width = min(cfg["max_dist"] // BINSIZE, GENOME_BINS) + max(np.shape(cfg["kernels"][0])) + 1
    bands = sum(4 * (end - start) * width for start, end in
                (source.extent(chrom) for chrom in source.chromnames))
    packed = band_uploads(source, "instruments")
    check(all(r["shape"][1] == width for r in observability.band_uploads().values()),
          "instruments: band widths")
    check(compute.get("band_normxcorr", {}).get("dispatches") == len(source.chromnames),
          f"instruments: band dispatches {compute.get('band_normxcorr')}")
    check(compute["band_preprocess"]["dispatches"] == len(source.chromnames),
          "instruments: band_preprocess dispatches")
    check(link.get("upload") == packed,
          f"instruments: uploads {link.get('upload')}, the packed bands hold {packed} bytes")
    check(link.get("download", 0) > 0, "instruments: no download counted")
    print(f"[instruments] {compute['band_normxcorr']['dispatches']} band dispatches; uploads "
          f"{link['upload']} bytes = the packed bands' ({packed} reckoned from their modes; "
          f"float32 bands {bands} bytes, {bands / packed:.2f}x); downloads {link['download']}")

    # a profiler trace of one chromosome's detect pass
    trace_dir = pathlib.Path(workdir) / "trace"
    genome = HicGenome(source, kernel_config=cfg, device=DEVICE)
    quietly(genome.normalize, "auto")
    quietly(genome.make_sub_matrices)
    cm = genome.sub_mats.contact_map[0]
    cm.create_mat()
    os.environ["CHROMOSIGHT_TPU_PROFILE"] = str(trace_dir)
    try:
        with observability.maybe_trace():
            detect_multi(cm, cfg, [np.asarray(cfg["kernels"][0])])
            torch.cuda.synchronize()
    finally:
        del os.environ["CHROMOSIGHT_TPU_PROFILE"]
    cm.destroy_mat()
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    text = traces[0].read_text() if traces else ""
    symbols = sorted(set(re.findall(r'"name":\s*"([^"]*band_pearson_tiled[^"]*)"', text)))
    print(f"[instruments] maybe_trace over {cm.name}: {len(traces)} trace file(s), "
          f"{sum(t.stat().st_size for t in traces)} bytes, {len(symbols)} band kernel symbol(s)")
    check(len(traces) == 1 and symbols, "instruments: the trace names no band kernel")

    # the card's busy share over the genome's whole detect run (open, maps,
    # scan, write), from a trace: maybe_trace wraps the command in `main`,
    # so a direct `detect` call takes it here
    trace_dir = pathlib.Path(workdir) / "genome_trace"
    os.environ["CHROMOSIGHT_TPU_PROFILE"] = str(trace_dir)
    try:
        t0 = time.perf_counter()
        with observability.maybe_trace():
            run_detect()
        wall = time.perf_counter() - t0
    finally:
        del os.environ["CHROMOSIGHT_TPU_PROFILE"]
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    check(len(traces) == 1, "instruments: no trace of the genome's detect run")
    busy, span, kernels = device_busy(traces[0], top=3)
    print(f"[instruments] genome loops detect under the profiler: wall {wall:.2f} s; the "
          f"traced detect run spans {span:.3f} s, the card busy {busy:.4f} s of it "
          f"({100 * busy / span:.2f}%, idle {100 - 100 * busy / span:.2f}%); device s by "
          "kernel: " + ", ".join(f"{k.split('::')[-1][:24]} {v:.4f}" for k, v in kernels.items()))

    # the exit report of a command-line process
    code = ("from chromosight_torch.cli.main import main; "
            f"main(['detect', '--no-plotting', {EXAMPLE_COOL!r}, {workdir + '/report'!r}])")
    env = dict(os.environ, CHROMOSIGHT_TPU_TIMINGS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600)
    check(res.returncode == 0, f"instruments: CLI failed: {res.stderr[-2000:]}")
    head = "-- chromosight-torch stage timings --"
    report = res.stderr[res.stderr.find(head):] if head in res.stderr else ""
    lines = report.strip().splitlines()
    sys.stderr.write("[instruments] CLI exit report (CHROMOSIGHT_TPU_TIMINGS=1):\n"
                     + "\n".join(lines) + "\n")
    print(f"[instruments] CLI exit report (CHROMOSIGHT_TPU_TIMINGS=1): {len(lines)} lines "
          "(on stderr), band_normxcorr's 3 dispatches in it")
    check("band_normxcorr " in report and "(3 dispatches)" in report,
          "instruments: no exit report")


def quietly(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def api_genome(path, device=None, **kwargs):
    """``HicGenome(path, ...)`` normalized, its maps listed (not made)."""
    genome = HicGenome(path, device=device, **kwargs)
    quietly(genome.normalize, norm="auto")
    quietly(genome.make_sub_matrices)
    return genome


def same_calls(a, b, what, tol=2e-5):
    """Two pattern tables (DataFrames): the same coordinates, NaN
    pattern, score within ``tol`` and log10 p within 2e-3 where both are
    finite; the score max|d|."""
    check((a is None) == (b is None), f"{what}: one side found nothing")
    if a is None:
        return 0.0
    a, b = a.reset_index(drop=True), b.reset_index(drop=True)
    check(a[["bin1", "bin2"]].equals(b[["bin1", "bin2"]]), f"{what}: coordinates differ")
    sa, sb = a.score.to_numpy(), b.score.to_numpy()
    check(np.array_equal(np.isnan(sa), np.isnan(sb)), f"{what}: NaN scores differ")
    ok = ~np.isnan(sa)
    err = float(np.abs(sa[ok] - sb[ok]).max(initial=0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        la, lb = np.log10(a.pvalue.to_numpy()), np.log10(b.pvalue.to_numpy())
    both = np.isfinite(la) & np.isfinite(lb)
    check(err < tol, f"{what}: scores differ by {err}")
    check(np.abs(la[both] - lb[both]).max(initial=0.0) < 2e-3, f"{what}: p-values differ")
    return err


def api_quantify_flow(device):
    """quantify_api.ipynb's flow on data_test/example.bed2: bins of the
    anchors, then ``pattern_detector`` at the first chromosome's pairs."""
    import chromosight_torch.detection as ctd
    import chromosight_torch.kernels as ck
    from chromosight_torch.io import load_bed2d

    config = ck.loops
    genome = api_genome(EXAMPLE_COOL, device, kernel_config=config)
    coords_bp = load_bed2d("data_test/example.bed2")
    bins1 = genome.coords_to_bins(coords_bp[["chrom1", "start1"]].rename(
        columns={"chrom1": "chrom", "start1": "pos"}))
    bins2 = genome.coords_to_bins(coords_bp[["chrom2", "start2"]].rename(
        columns={"chrom2": "chrom", "start2": "pos"}))
    inside = ~(np.isnan(bins1.astype(float)) | np.isnan(bins2.astype(float)))
    pairs = np.stack([bins1[inside], bins2[inside]], axis=1).astype(int)
    genome.max_dist = int(np.abs(pairs[:, 1] - pairs[:, 0]).max()) + 1
    quietly(genome.make_sub_matrices)
    sub = genome.sub_mats.iloc[0]
    quietly(sub.contact_map.create_mat)
    kernel = np.asarray(config["kernels"][0])
    return ctd.pattern_detector(sub.contact_map, config, kernel, coords=pairs, full=True)


def phase_api(source):
    """The Python API of docs/TUTORIAL.md and the notebooks on the card:
    TUTORIAL's block and detect_example.ipynb's loop on the example map
    (the calls of the per-map path of the command line), quantify_api.
    ipynb's flow against the CPU's; the notebook loop at full width on the
    13 x 48,000 genome with ``kernels.loops`` (launches, calls identical
    to ``detect_multi``'s on the same maps, the wall beside phase 5's
    detect wall); ``full=False`` on the example map and on the genome's
    chr1 against the same run on the CPU."""
    import pandas as pd

    import chromosight_torch.kernels as ck
    import chromosight_torch.utils.detection as cud

    kernel = np.asarray(ck.loops["kernels"][0])
    # docs/TUTORIAL.md's Python API block, on the card by default
    g = api_genome(EXAMPLE_COOL, kernel_config=dict(ck.loops))
    g.compute_max_dist()
    quietly(g.make_sub_matrices)
    cm = g.sub_mats.contact_map[0]
    quietly(cm.create_mat)
    corr, logp = cud.normxcorr2(cm.matrix, ck.loops["kernels"][0], pval=True)
    coords, foci = cud.pick_foci(corr, pearson=0.3)
    reset_launches()
    patterns, windows = cud.pattern_detector(
        cm, dict(ck.loops, tsvd=None), ck.loops["kernels"][0], full=True)
    seen = launches()
    print(f"[api] TUTORIAL block on {EXAMPLE_COOL}: normxcorr2 + pick_foci {len(coords)} "
          f"foci on {cm.name}; pattern_detector(full=True) {len(patterns)} calls, windows "
          f"{windows.shape}; launches {seen}")
    check(seen == {"single": 1, "multi": 0} and len(patterns) == len(windows) > 0,
          "TUTORIAL block")
    # the JAX package's views: a host float64 band, the device tensor
    band, band_dev = cm.band, cm.band_dev
    check(isinstance(band, np.ndarray) and band.dtype == np.float64 and band_dev.is_cuda
          and np.array_equal(band, band_dev.cpu().numpy().astype(np.float64))
          and band.shape == (cm.shape[0], cm.keep_distance + 1), "cm.band against band_dev")
    cm.destroy_mat()
    same = []
    with tempfile.TemporaryDirectory() as tmp:
        for command, argv in (("detect", ["detect", "--no-plotting", EXAMPLE_COOL]),
                              ("quantify", ["quantify", "--no-plotting",
                                            "data_test/example.bed2", EXAMPLE_COOL])):
            quietly(main, [*argv, f"{tmp}/main"], device=DEVICE)
            run = cli.cmd_detect if command == "detect" else cli.cmd_quantify
            quietly(run, parse_args([*argv, f"{tmp}/cmd"], ""), DEVICE)
            check(outputs(f"{tmp}/cmd") == outputs(f"{tmp}/main") and outputs(f"{tmp}/main"),
                  f"cmd_{command}'s files differ from main's")
            same.append(f"cmd_{command}")
    print(f"[api] {' and '.join(same)}: main's files byte for byte; cm.band {band.shape} "
          "float64 on the host, band_dev's values")

    # detect_example.ipynb's loop against the command line's per-map path
    results, n_maps = [], 0
    for _, sub in g.sub_mats.iterrows():
        quietly(sub.contact_map.create_mat)
        calls, wins = cud.pattern_detector(sub.contact_map, ck.loops, kernel, full=True)
        cli_calls, cli_wins = detect_multi(sub.contact_map, ck.loops, [kernel])[0]
        check(calls.equals(pd.DataFrame(cli_calls)) and np.array_equal(
            wins, cli_wins, equal_nan=True), f"{sub.chr1}: API calls differ from the CLI path")
        results.append(g.get_full_mat_pattern(sub.chr1, sub.chr2, calls))
        sub.contact_map.destroy_mat()
        n_maps += 1
    example_calls = pd.concat(results, ignore_index=True)
    print(f"[api] detect_example.ipynb loop: {len(example_calls)} calls over {n_maps} maps, "
          "each map's identical to the command line's per-map full-mode calls")

    # quantify_api.ipynb on the card and on the CPU
    (card, card_w), (plain, plain_w) = api_quantify_flow(None), api_quantify_flow("cpu")
    err = same_calls(plain, card, "quantify_api flow")
    print(f"[api] quantify_api.ipynb flow: {len(card)} pairs, {int(card.score.notna().sum())} "
          f"scored, as on the CPU (score max|d| {err:.3g})")
    check(np.array_equal(np.isnan(card_w), np.isnan(plain_w)), "quantify flow windows")

    # full=False on each map of the example, card against CPU
    def valid_mode(device):
        genome = api_genome(EXAMPLE_COOL, device, kernel_config=ck.loops)
        tables = []
        for cm in genome.sub_mats.contact_map:
            quietly(cm.create_mat)
            tables.append(cud.pattern_detector(cm, ck.loops, kernel, full=False)[0])
            cm.destroy_mat()
        return tables

    card, plain = valid_mode(None), valid_mode("cpu")
    errs = [same_calls(b, a, "full=False on the example") for a, b in zip(card, plain)]
    print(f"[api] full=False on the example's {len(card)} maps: "
          f"{sum(len(t) for t in card if t is not None)} calls, the CPU's; score max|d| "
          f"{max(errs):.3g}")

    # the notebook loop at full width on the 13 x 48,000 genome
    genome = api_genome(source, kernel_config=ck.loops)
    reset_launches()
    t0 = time.perf_counter()
    per_map = []
    for _, sub in genome.sub_mats.iterrows():
        quietly(sub.contact_map.create_mat)
        calls, wins = cud.pattern_detector(sub.contact_map, ck.loops, kernel, full=True)
        per_map.append((calls, wins))
        sub.contact_map.destroy_mat()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seen = launches()
    n_calls = sum(len(c) for c, _ in per_map if c is not None)
    check(seen == {"single": len(per_map), "multi": 0}, f"API genome launches {seen}")
    for cm, (calls, wins) in zip(genome.sub_mats.contact_map, per_map):
        quietly(cm.create_mat)
        cli_calls, cli_wins = detect_multi(cm, ck.loops, [kernel])[0]
        cm.destroy_mat()
        check(calls.equals(pd.DataFrame(cli_calls)) and np.array_equal(
            wins, cli_wins, equal_nan=True), f"{cm.name}: API calls differ from detect_multi")
    print(f"[api] notebook loop on {len(per_map)} x {GENOME_BINS} bins with kernels.loops: "
          f"{n_calls} calls, each map's detect_multi's, API wall {wall:.2f} s (phase 5's detect "
          f"wall {WALLS['detect loops']:.2f} s); launches {seen}")

    # full=False on chr1 of the genome, card against CPU
    valid = {}
    for device in (None, "cpu"):
        genome = api_genome(source, device, kernel_config=ck.loops)
        cm = genome.sub_mats.contact_map[0]
        quietly(cm.create_mat)
        t0 = time.perf_counter()
        valid[device] = cud.pattern_detector(cm, ck.loops, kernel, full=False)[0]
        valid[(device, "wall")] = time.perf_counter() - t0
        cm.destroy_mat()
    err = same_calls(valid["cpu"], valid[None], "full=False on chr1")
    print(f"[api] full=False on {cm.name} ({cm.shape[0]} bins, not cut): "
          f"{len(valid[None])} calls, the CPU's (score max|d| {err:.3g}); wall on the card "
          f"{valid[(None, 'wall')]:.2f} s, on the CPU {valid[('cpu', 'wall')]:.2f} s")


def run(quick):
    phase_env()
    phase_build()
    phase_kernels_small()
    if quick:
        print("[quick] env, build and small kernel checks passed")
        return
    t0 = time.perf_counter()
    source = ArraySource.from_synthetic(GENOME_CHROMS, GENOME_BINS, seed=0, binsize=BINSIZE)
    print(f"[genome] synthetic genome {GENOME_CHROMS} x {GENOME_BINS} bins, "
          f"{source.nnz} pixels, generated and balanced in "
          f"{time.perf_counter() - t0:.1f} s")
    times, bounds = phase_kernels_chromosome(source)
    with tempfile.TemporaryDirectory() as workdir:
        # the bench's genomes are cached in the work directory, at its sizes
        os.environ.update(CHROMOSIGHT_BENCH_CACHE=f"{workdir}/bench",
                          CHROMOSIGHT_BENCH_GENOME_BINS=str(GENOME_CHROMS * GENOME_BINS),
                          CHROMOSIGHT_BENCH_GENOME_CHROMS=str(GENOME_CHROMS))
        phase_golden(workdir)
        phase_formats(workdir)
        runs = phase_genome(source, workdir)
        phase_instruments(source, workdir)
        phase_surface_example(workdir)
        phase_surface_genome(source, workdir)
        contiguous_read = phase_cool_genome(source, workdir)
        phase_bench(workdir)
        phase_cooler_genome(source, workdir, contiguous_read)
        phase_latest_genome(source, workdir)
        phase_userblock_genome(source, workdir)
        phase_szip_genome(source, workdir)
        phase_api(source)
        del source
        phase_golden_inter(workdir)
        phase_genome_inter(workdir)
        phase_genome_golden(workdir)
        phase_baseline_configs(workdir)
    check("jax" not in sys.modules, "jax was imported")
    check("h5py" not in sys.modules, "h5py was imported")
    check(not any(m.split(".")[0] == "chromosight_tpu" for m in sys.modules),
          "chromosight_tpu was imported")
    entry = {
        "route": "cuda",
        "source": "chromosight_torch/csrc/band_pearson.cu",
        "replaces": "chromosight_tpu/ops/pallas_band.py:31",
    }
    # ms: CUDA-event time of a call; kernel_ms: the kernel's own device
    # time (torch.profiler), null where the trace held none; no single
    # PyTorch call computes this function
    print(json.dumps({"kernels": [
        {"name": "band_pearson", **entry, "launches": runs["loops"]["single"],
         "max_abs_err": max(ERRS["single"]), "ms": times["loops"][0],
         "kernel_ms": times["loops"][1], "plain_ms": times["loops"][2],
         "bound_ms": bounds["loops"][0], "bound_by": bounds["loops"][1],
         "library_ms": None},
        {"name": "band_pearson_multi", **entry, "launches": runs["borders"]["multi"],
         "max_abs_err": max(ERRS["multi"]), "ms": times["borders"]["fused"][0],
         "kernel_ms": times["borders"]["fused"][1],
         "plain_ms": times["borders"]["plain"], "bound_ms": bounds["borders"][0],
         "bound_by": bounds["borders"][1], "library_ms": None},
    ]}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="env, build and small kernel checks only")
    quick = parser.parse_args().quick
    with contextlib.redirect_stdout(sys.stderr):
        run(quick)
