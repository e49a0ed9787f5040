#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (chromosight_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py            # all phases; last line is the result
    python3 chip_smoke.py --quick    # env, build and small kernel checks only

Phases, one line or block each; any failure raises (non-zero exit):

1. env      torch and CUDA versions, nvidia-smi's driver_version, the card,
            optional packages;
2. build    nvcc build of chromosight_torch/csrc/*.cu for sm_90a: registers
            and spills of every instance (ptxas), and the dynamic shared
            memory of the chr1 and centromeres launches;
3. kernels  the CUDA band Pearson against its plain PyTorch twin on the
            card, in single-kernel mode (random bands of tests/test_pallas.py
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
4. golden   ``detect`` on tests/data/example_cool.npz reproduces
            tests/data/golden_detect_loops{,_raw,_smooth,_tsvd}.tsv and
            golden_detect_borders.tsv (fused), the loops windows against
            tests/data/golden_detect_loops.json, the ``--dump`` snapshots of
            tests/data/golden_dump/, and ``quantify`` of data_test/example.bed2
            reproduces golden_quantify_loops.tsv and golden_quantify_borders.tsv;
5. genome   on a synthetic 13 x 48,000-bin genome at 5 kb (the bench.py
            shape): ``detect`` with loops (recall of the planted loops) and
            with borders (13 fused launches), and ``quantify`` of the planted
            loops written as a bed2d file, scores held against the sweep
            kernel's; walls, stages, launches and peak device memory;
6. golden-inter  ``detect --inter`` on tests/data/example_cool.npz
            reproduces tests/data/golden_detect_loops_inter.tsv on the dense
            engine and, with ``DENSE_LIMIT`` lowered to 50, on the tiled
            engine (tiles of 128); ``quantify --inter`` of the four pairs of
            tests/test_golden_outputs.py gives the same rows on both;
7. genome-inter  a synthetic 3 x 50,000-bin genome at 5 kb with trans
            contacts at 1e-3 of the cells: ``detect --inter`` with loops
            (recall, trans calls, tiles scanned and skipped, walls, stages,
            launches, peak device memory held below one dense trans map);
            then an 8,192 x 8,192 cut of a trans map through the dense and
            the tiled engines: the same corr, foci and calls (the 10%
            zero rule lifted for the calls);
8. surface  the rest of the command line: ``test`` (offline: the download
            is replaced by a failure, so it reads the npz fallback; 89
            patterns and the golden log lines), ``list-kernels --long
            --mat`` (seven presets), ``generate-config --preset borders``
            then ``detect --kernel-config`` of the file (the borders
            golden), ``--norm force`` on the npz (calls as the port's own
            CPU run's); on the 13 x 48,000 genome with its weights dropped,
            ``detect`` at ``--norm auto`` (ICE on the host, the table byte
            for byte phase 5's), ``--threads`` 1, 2 and 4 and two workers
            on the one card (tables byte for byte the serial one's; walls,
            stages, launches, peak memory); ``--subsample 0.5`` on its
            first three chromosomes (the 10% zero rule lifted: half the
            contacts leave most windows of this map over 10% zeros),
            ``--threads 4`` against ``--threads 1`` with one seed; and the
            native band scatter of the genome on the main thread and on a
            thread of its own.  It runs after phase 5, on the same genome.
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
            the seed-0 3 x 50,000 genome, its fingerprint checked: the same
            calls, score max|d| < 5e-5, log10 p max|d| < 1e-3.

It prints the kernel table and the card's ``nvidia-smi`` name and power
limit, then ``{"ok": true, "device": {...}}`` as its last line.  Without a
CUDA card, or outside the repository, it exits non-zero and prints no
result.
"""

import argparse
import contextlib
import copy
import csv
import ctypes
import io
import json
import os
import pathlib
import re
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
import chromosight_torch.ops.band_pearson as bp  # noqa: E402
import chromosight_torch.ops.tiled as tiled  # noqa: E402
import chromosight_torch.runtime.contact_map as contact_map  # noqa: E402
from chromosight_torch.cli.main import detect, main, parse_args, quantify  # noqa: E402
from chromosight_torch.detection import (  # noqa: E402
    detect_multi,
    frame_contact_map,
    pattern_detector,
    pick_foci,
    quantify_banded,
)
from chromosight_torch.device import reset_stages, stage_seconds  # noqa: E402
from chromosight_torch.io.config import load_kernel_config  # noqa: E402
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
from chromosight_torch.runtime.genome import HicGenome  # noqa: E402

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
# walls (s) of the main-path runs, by name
WALLS = {}
EXAMPLE_NPZ = "tests/data/example_cool.npz"
# genome-golden: the genome of tests/data/golden_genome_meta.json
GOLDEN_CHROMS, GOLDEN_BINS = 3, 50_000
# the windows of tests/test_fp32_boundaries.py
FP32_N, FP32_WIDTH, FP32_MAX_DIST = 512, 128, 100


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


def launches():
    return {"single": bp.LAUNCHES, "multi": bp.LAUNCHES_MULTI}


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
    print(f"[env] host native scatter (g++): {native_scatter_available()}")
    print(nvidia_smi("name,power.limit"))


def phase_build():
    _build.load()
    info = _build.BUILD_INFO
    print(f"[build] {info['path']} in {info['seconds']:.2f} s")
    kernels_per_launch, entry, own = None, None, False
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            entry, own = line.split("'")[1], True
            inst = re.search(r"band_pearson_tiledILi(\d+)ELi(\d+)E", line)
            side = inst and ("any shape" if inst.group(1) == "0"
                             else f"{inst.group(1)}x{inst.group(1)}")
            kernels_per_launch = (
                f"{side}, {inst.group(2)} diagonals per thread" if inst else "?")
        elif "Function properties for" in line:
            # the outlined epilogue functions report their own frames
            own = entry is not None and line.rstrip().endswith(entry)
        elif "registers" in line or ("spill" in line and own):
            print(f"[build] {kernels_per_launch}: {line.split(':', 1)[-1].strip()}")
    lib = _build.load()
    lib.band_pearson_smem_bytes.restype = ctypes.c_longlong
    for side, k, w_out in ((17, 1, 418), (17, 3, 418), (17, 3, 19), (81, 1, 122)):
        smem = lib.band_pearson_smem_bytes(side, side, k, w_out)
        print(f"[build] dynamic shared memory, {side}x{side} K={k} at {w_out} "
              f"diagonals: {smem} bytes per block")


def compare(name, ref, got, n, max_dist, pearson=PEARSON):
    """Kernel output ``got`` against the plain twin ``ref`` (both on the
    card): corr within 2e-5, log10-p within 2e-3 and equal finiteness on
    valid pixels, candidate flips only within 1e-4 of the threshold."""
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
    logp_err = float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0
    print(f"[kernels] {name}: corr max|d| {corr_err:.3g}, log10p max|d| "
          f"{logp_err:.3g}, cand flips {int(flips.sum())} (max gap {flip_gap:.2g}), "
          f"candidates {int(cand_r.sum())}")
    check(corr_err < 2e-5, f"{name}: corr differs by {corr_err}")
    check(same_kind, f"{name}: log10p finiteness differs")
    check(logp_err < 2e-3, f"{name}: log10p differs by {logp_err}")
    check(flip_gap < 1e-4, f"{name}: candidate flip {flip_gap} from the threshold")
    return corr_err


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
    ERRS["single"].append(compare(name, ref, got, n, max_dist, pearson))


def run_multi(name, sig_p, mask_p, kernels, n, max_dist, pearson=PEARSON):
    """K-kernel launch against K single launches (bit for bit on every
    output, NaN included) and against the plain K-kernel twin."""
    args = (n, max_dist, MISSING_TOL, pearson)
    got = bp.band_pearson(sig_p, mask_p, kernels, *args)
    singles = [bp.band_pearson(sig_p, mask_p, k, *args) for k in kernels]
    ref = pearson_reference_multi(sig_p, mask_p, kernels, *args)
    torch.cuda.synchronize()
    for k, single in enumerate(singles):
        for out, one in zip(got, single):
            check(torch.equal(out[k].view(torch.uint8), one.view(torch.uint8)),
                  f"{name}: K-kernel slice {k} differs from its single launch")
        ERRS["multi"].append(compare(
            f"{name} k={k}", [r[k] for r in ref], [g[k] for g in got], n, max_dist,
            pearson,
        ))
    print(f"[kernels] {name}: K={len(kernels)} launch bit-identical to "
          f"{len(kernels)} single launches")


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
    print(f"[kernels] work at {n_k}x{mk}x{nk} on ({n_pad}, {w_out}): window taps over "
          f"a non-zero x {x_taps / (pixels * mk * nk):.4f}, over a set mask bit "
          f"{m_taps / (pixels * mk * nk):.4f}; {fmas:.6g} FMAs needed of {dense:.6g} dense")
    return (t_ops, "operations", fmas, dense) if t_ops >= t_bytes else (
        t_bytes, "bytes", fmas, dense)


def phase_kernels_small():
    for preset in ("loops_small", "hairpins", "loops", "stripes_left"):
        kernel = np.asarray(load_kernel_config(preset)["kernels"][0], np.float32)
        case = random_case(kernel.shape, 300, 512, np.random.RandomState(0))
        run_both(f"{preset} n_pad=512", *case[:2], kernel, 300, case[2])
    for shape in ((5, 9), (3, 17)):
        rng = np.random.RandomState(11)
        kernel = (rng.rand(*shape) + 0.1).astype(np.float32)
        case = random_case(shape, 300, 512, rng)
        run_both(f"{shape} n_pad=512", *case[:2], kernel, 300, case[2])
    cfg = load_kernel_config("centromeres")
    kernel = cfg["kernels"][0]
    case = random_case(kernel.shape, 400, 400, np.random.RandomState(2))
    run_both("centromeres 81x81 n=400", *case[:2], kernel, 400, case[2], cfg["pearson"])
    kernel = load_kernel_config("loops")["kernels"][0]
    case = random_case(kernel.shape, 300, 512, np.random.RandomState(0))
    run_both("loops --tsvd n_pad=512", *case[:2], kernel, 300, case[2], tsvd=TSVD)
    borders = np.stack(load_kernel_config("borders")["kernels"])
    case = random_case(borders.shape[1:], 300, 512, np.random.RandomState(0))
    run_multi("borders n_pad=512", *case[:2], borders, 300, case[2])
    rng = np.random.RandomState(7)
    nine = rng.rand(9, 5, 9) + 0.1
    case = random_case((5, 9), 300, 512, rng)
    run_multi("nine 5x9 n_pad=512", *case[:2], nine, 300, case[2])
    stripes = np.stack([load_kernel_config(name)["kernels"][0]
                        for name in ("stripes_left", "stripes_right", "stripes_left")])
    case = random_case(stripes.shape[1:], 300, 512, np.random.RandomState(4))
    run_multi("three 31x31 (2 + 1 launches) n_pad=512", *case[:2], stripes, 300, case[2])
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
    file's bounds (the guard case: the bounds the port meets, and its
    disagreements outside the variance region counted; ROADMAP section 3)."""
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
            gap = float(np.abs(corr32 - corr64)[out].max(initial=0.0))
            ok = (corr32[64, 40] == 0 == corr64[64, 40] and corr32[200, 40] != 0
                  and corr64[200, 40] != 0 and gap < 5e-5
                  and np.abs(corr64[out]).max(initial=0.0) < PEARSON)
            detail = (f"{int(flip.sum())} zero/non-zero disagreements, {int(out.sum())} of "
                      f"them outside the variance region (max |d| {gap:.3g})")
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
    shape = tuple(cm.band.shape)
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
    bshape = tuple(cm.band.shape)
    bargs = (cm.shape[0], cm.max_dist, cfg["max_perc_undetected"] / 100, cfg["pearson"])
    run_multi(f"borders {cm.name} {bshape}", sig_p, mask_p, kernels, *bargs[:2],
              bargs[3])
    times["borders"] = fused_times(sig_p, mask_p, kernels, bargs)
    bounds["borders"] = bound_ms(sig_p, mask_p, kernels, rate)
    cm.destroy_mat()
    print("[kernels] ms per call, median of 5 by CUDA events (tap table cached on "
          "the card; kernel-only time from torch.profiler in brackets)")
    for key, name in (("loops", "loops 17x17"), ("tsvd", "loops 17x17 --tsvd")):
        ev, kern, plain = times[key]
        print(f"[kernels] {name} at {shape}: kernel {ev:.3f} [{fmt_ms(kern)}], "
              f"plain {plain:.3f}")
    for key, where in (("borders_wide", shape), ("borders", bshape)):
        t = times[key]
        print(f"[kernels] borders K=3 17x17 at {where}: fused launch {t['fused'][0]:.3f} "
              f"[{fmt_ms(t['fused'][1])}], 3 single launches {t['three'][0]:.3f} "
              f"[{fmt_ms(t['three'][1])}], plain twin {t['plain']:.3f}")
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
            f"{fmas / ms / 1e9:.4g} needed, {dense / ms / 1e9:.4g} dense")
        print(f"[kernels] {name}: kernel-only {fmt_ms(ms)} ms (events {ev:.3f}), "
              f"bound {b:.4f} ms ({by}), share of the bound {share} "
              f"(events {100 * b / ev:.1f}%); float64 FMAs per second (T): {rates}")
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


def read_tsv(path):
    with open(path) as handle:
        return list(csv.DictReader(handle, delimiter="\t"))


def num(value):
    return float(value) if value != "" else float("nan")


def golden_detect(workdir, golden, flags, expect, tol=1e-5):
    """``detect`` with ``flags`` against tests/data/<golden>.tsv: the same
    (bin1, bin2, kernel_id, iteration) calls, score within 5e-5, p-value
    and q-value within ``tol`` (1e-6 for the loops golden, 1e-5 for the
    others, as tests/test_golden_outputs.py holds them); ``expect`` the
    launches of each mode."""
    prefix = f"{workdir}/{golden}"
    reset_launches()
    with open(f"{workdir}/stdout.txt", "a") as out:
        stdout, sys.stdout = sys.stdout, out
        try:
            rc = main(["detect", "--no-plotting", *flags,
                       "tests/data/example_cool.npz", prefix], device=DEVICE)
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
    print(f"[golden] {golden}: {len(ref)}/{len(ref)} calls identical; max|d| score "
          f"{err['score']:.3g}, pvalue {err['pvalue']:.3g}, qvalue {err['qvalue']:.3g} "
          f"(bound {tol:g}); launches {seen}")
    check(err["score"] < 5e-5 and err["pvalue"] < tol and err["qvalue"] < tol,
          f"{golden}: {err}")
    check(seen == expect, f"{golden}: expected launches {expect}, saw {seen}")
    return prefix


def golden_quantify(workdir, golden, flags, pvalue_tol):
    """``quantify`` of data_test/example.bed2 against tests/data/<golden>.tsv
    (tests/test_golden_outputs.py:124-173)."""
    prefix = f"{workdir}/{golden}"
    reset_launches()
    check(main(["quantify", "--no-plotting", *flags, "data_test/example.bed2",
                "tests/data/example_cool.npz", prefix], device=DEVICE) == 0,
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
    print(f"[golden] {golden}: 53/53 rows, max|d| score {err['score']:.3g}, "
          f"pvalue {err['pvalue']:.3g}; launches {launches()} (no sweep)")
    check(err["score"] < 5e-5 and err["pvalue"] < pvalue_tol, f"{golden}: {err}")


def golden_dump(workdir):
    """``--dump`` snapshots against tests/data/golden_dump/ as
    tests/test_golden_outputs.py:268-330 compares them."""
    import pathlib

    import scipy.sparse as sp

    dump = pathlib.Path(workdir) / "dump"
    golden_detect(workdir, "golden_detect_loops", ["--dump", str(dump)],
                  {"single": 3, "multi": 0}, tol=1e-6)
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
    golden_quantify(workdir, "golden_quantify_loops", [], 1e-6)
    golden_quantify(workdir, "golden_quantify_borders", ["--pattern", "borders"], 5e-5)


def run_genome(name, fn, tag="genome"):
    """One main-path run on a genome: launches counted from 0, stages,
    wall (kept in ``WALLS``) and peak device memory."""
    reset_stages()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    wall = WALLS[name] = time.perf_counter() - t0
    seen = launches()
    print(f"[{tag}] {name}: wall {wall:.2f} s, launches {seen}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"[{tag}] {name} stages (s): "
          + json.dumps({k: round(v, 3) for k, v in sorted(stage_seconds().items())}))
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
          f"{err:.3g} of the sweep kernel's corr on {tuple(cm.band.shape)}")
    check(err < 2e-5, f"quantify differs from the sweep by {err}")
    check(np.allclose(at["score"], table["score"][sel], equal_nan=True),
          "chr1 quantify differs from the genome run")
    cm.destroy_mat()


def phase_genome(source, workdir):
    runs = {}
    args = parse_args(["detect", "--no-plotting", "synthetic", f"{workdir}/genome"], "")
    (table, _), seen = run_genome("detect loops", lambda: detect(source, args, DEVICE))
    runs["loops"] = seen
    recall = planted_recall(source, table)
    print(f"[genome] {len(source.chromnames)} x {GENOME_BINS} bins, loops: "
          f"{len(table['bin1'])} calls, recall {recall:.4f} ({len(source.planted)} "
          f"planted, +-2 bins)")
    n_chroms = len(source.chromnames)
    check(seen == {"single": n_chroms, "multi": 0}, f"loops launches {seen}")
    check(recall >= 0.95, f"recall {recall} below 0.95")
    check(all(np.isfinite(table["score"])) and all(np.isfinite(table["pvalue"])),
          "non-finite scores")

    args = parse_args(["detect", "--no-plotting", "--pattern", "borders", "synthetic",
                       f"{workdir}/borders"], "")
    (table, _), seen = run_genome("detect borders", lambda: detect(source, args, DEVICE))
    runs["borders"] = seen
    n_calls = 0 if table is None else len(table["bin1"])
    print(f"[genome] borders: {n_calls} calls from {seen['multi']} fused launches")
    check(seen == {"single": 0, "multi": n_chroms}, f"borders launches {seen}")
    if table is not None:
        check(all(np.isfinite(table["score"])), "non-finite border scores")

    bed = f"{workdir}/planted.bed2"
    write_planted_bed2d(source, bed)
    args = parse_args(["quantify", "--no-plotting", bed, "synthetic",
                       f"{workdir}/quantify"], "")
    (table, windows), seen = run_genome(
        "quantify planted loops", lambda: quantify(source, args, DEVICE)
    )
    runs["quantify"] = seen
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
    return runs


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
    print(f"[surface] test: {n_calls} patterns from {cli.example_dataset()}, log lines "
          f"{'equal' if lines == set(cli.TEST_LOG.split(chr(10))) else 'differ from'} "
          f"TEST_LOG; launches {seen}")
    check(n_calls == 89 and lines == set(cli.TEST_LOG.split("\n")), "test log differs")
    check("test log differed" not in log, "test warned that its log differed")
    check(seen == {"single": 3, "multi": 0}, f"test launches {seen}")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        check(main(["list-kernels", "--long", "--mat"]) == 0, "list-kernels failed")
    names = [ln for ln in out.getvalue().splitlines() if ln and ln[0].isalpha()]
    print(f"[surface] list-kernels --long --mat: {len(names)} presets {names}, "
          f"{len(out.getvalue().splitlines())} lines")
    check(names == cli.kernel_names and len(names) == 7, "list-kernels presets")

    cfg = f"{workdir}/borders_cfg"
    check(main(["generate-config", "--preset", "borders", cfg]) == 0, "generate-config")
    golden_detect(workdir, "golden_detect_borders", ["--kernel-config", cfg + ".json"],
                  {"single": 0, "multi": 3})
    print("[surface] generate-config --preset borders: detect --kernel-config of the "
          "file reproduces golden_detect_borders.tsv")

    tables = {}
    for tag, device in (("card", DEVICE), ("cpu", "cpu")):
        prefix = f"{workdir}/force_{tag}"
        reset_launches()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            check(main(["detect", "--no-plotting", "--norm", "force",
                        "tests/data/example_cool.npz", prefix], device=device) == 0,
                  f"--norm force on the {tag} failed")
        tables[tag] = (read_tsv(prefix + ".tsv"), launches())
    (card, seen), (plain, _) = tables["card"], tables["cpu"]
    key = ("bin1", "bin2", "kernel_id", "iteration")
    same = [tuple(r[k] for k in key) for r in card] == [tuple(r[k] for k in key) for r in plain]
    err = max(abs(num(a["score"]) - num(b["score"])) for a, b in zip(card, plain))
    print(f"[surface] --norm force: {len(card)} calls on the card, {len(plain)} on the "
          f"CPU, identical {same}, score max|d| {err:.3g}; launches {seen}")
    check(same and len(card) == 89 and err < 5e-5, "--norm force calls differ")
    check(seen == {"single": 3, "multi": 0}, f"--norm force launches {seen}")


def genome_run(source, workdir, tag, flags=(), device=DEVICE, rng=None):
    """``detect`` with ``flags`` on a genome source (counts from 0, wall,
    stages, peak memory): (table, launches, tsv and windows bytes)."""
    prefix = f"{workdir}/{tag}"
    args = parse_args(["detect", "--no-plotting", *flags, "synthetic", prefix], "")

    def run():
        with contextlib.redirect_stdout(io.StringIO()):
            return detect(source, args, device, rng)

    (table, _), seen = run_genome(f"detect {tag}", run)
    out = pathlib.Path(prefix + ".tsv").read_bytes() + pathlib.Path(prefix + ".json").read_bytes()
    return table, seen, out


def scatter_seconds(source, width=418):
    """Seconds of the native band scatter of every chromosome of the
    genome, on the calling thread."""
    t0 = time.perf_counter()
    for chrom in source.chromnames:
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
    walls = {}
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
        print(f"[surface] {tag}: wall {walls[tag]:.2f} s, peak device memory {peak:.3f} GiB, "
              f"byte-identical to the serial table: {out == stored}; launches {seen}")
        check(out == stored, f"{tag}: table differs from the serial run")
        check(seen == {"single": n_chroms, "multi": 0}, f"{tag}: launches {seen}")
    print("[surface] walls (s): " + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    # why the scheduler's producer is the caller's thread
    times = [(scatter_seconds(source), on_new_thread(scatter_seconds, source))
             for _ in range(2)]
    print("[surface] native band scatter of the genome's chromosomes (s), on the main "
          "thread / on a thread of its own: "
          + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in times))

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
        print(f"[surface] --subsample 0.5 --threads {threads} on {first} x {GENOME_BINS}: "
              f"{len(table['bin1'])} calls, recall {planted_recall(cut, table):.4f}, wall "
              f"{time.perf_counter() - t0:.2f} s, launches {seen}")
        check(seen == {"single": first, "multi": 0}, f"--subsample launches {seen}")
        check(len(table["bin1"]) > 0, "--subsample: no call")
    check(outs["1"] == outs["4"], "--subsample: --threads 4 differs from --threads 1")
    print("[surface] --subsample: --threads 4 byte-identical to --threads 1 (one seed)")


def inter_quantify(workdir, tag):
    """``quantify --inter`` of the four pairs; the rows as dicts."""
    bed = f"{workdir}/inter_pairs.bed2"
    with open(bed, "w") as handle:
        handle.write(INTER_PAIRS)
    prefix = f"{workdir}/inter_quantify_{tag}"
    check(main(["quantify", "--no-plotting", "--inter", bed,
                "tests/data/example_cool.npz", prefix], device=DEVICE) == 0,
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
            tiled.TILES.update(scanned=0, skipped=0, scattered=0)
            golden_detect(workdir, "golden_detect_loops_inter", ["--inter"],
                          {"single": 3, "multi": 0})
            scanned = tiled.TILES["scanned"]
            check((scanned > 0) == (tag == "tiled"), f"{tag}: {scanned} tiles scanned")
            print(f"[golden-inter] {tag} engine: {scanned} tiles scanned")
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
        cm = ContactMap(None, [(0, INTER_CUT), (0, INTER_CUT)], DEVICE, name="cut",
                        detectable_bins=det, inter=True)
        if form == "dense":
            cm.dense = torch.from_numpy(cut.toarray().astype(np.float64)).to(DEVICE)
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
    args = parse_args(["detect", "--no-plotting", "--inter", "synthetic",
                       f"{workdir}/inter"], "")
    tiled.TILES.update(scanned=0, skipped=0, scattered=0)
    (table, _), seen = run_genome("detect --inter loops",
                                  lambda: detect(source, args, DEVICE))
    peak = torch.cuda.max_memory_allocated()
    dense_map = 4 * INTER_BINS * INTER_BINS
    trans = table["chrom1"] != table["chrom2"]
    recall = planted_recall(source, table)
    scan = stage_seconds().get("tile scan", 0.0)
    pixels = tiled.TILES["scanned"] * tiled.DEFAULT_TILE ** 2
    print(f"[genome-inter] {len(table['bin1'])} calls, {int(trans.sum())} trans; recall "
          f"{recall:.4f} ({len(source.planted)} planted, +-2 bins); tiles "
          f"{json.dumps(tiled.TILES)} of {tiled.DEFAULT_TILE}, batches of "
          f"{tiled.TILE_BATCH}; tile scan {scan:.3f} s for {pixels:.4g} output pixels; "
          f"peak device memory {peak / 2**30:.3f} GiB, {100 * peak / dense_map:.1f}% of one "
          f"dense f32 trans map ({dense_map / 2**30:.2f} GiB)")
    check(seen == {"single": INTER_CHROMS, "multi": 0}, f"--inter launches {seen}")
    check(recall >= 0.95, f"--inter recall {recall} below 0.95")
    check(tiled.TILES["scanned"] > 0, "no tile scanned")
    check(tiled.TILES["scattered"] == tiled.TILES["scanned"],
          "a sparse trans tile took the dense conv2d numerator")
    check(peak < dense_map / 2, f"peak device memory {peak} near a dense trans map")
    check(all(np.isfinite(table["score"])) and all(np.isfinite(table["pvalue"])),
          "non-finite --inter scores")
    check_inter_cut(source)


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
    tools/make_synthetic_cool.py, its fingerprint checked, ``detect`` at
    --norm auto with loops and with borders, held to the bounds of
    tests/test_golden_genome_scale.py."""
    t0 = time.perf_counter()
    source = ArraySource.from_synthetic(GOLDEN_CHROMS, GOLDEN_BINS, seed=0, binsize=BINSIZE)
    meta = json.loads(pathlib.Path("tests/data/golden_genome_meta.json").read_text())
    got = source_fingerprint(source)
    print(f"[genome-golden] synthetic genome {GOLDEN_CHROMS} x {GOLDEN_BINS} bins, seed 0: "
          f"generated and balanced in {time.perf_counter() - t0:.1f} s; fingerprint "
          f"{json.dumps(got)}, the goldens' {json.dumps(meta['fingerprint'])}")
    check(got == meta["fingerprint"], "genome-golden: fingerprint differs")
    for name, flags, expect in (("loops", [], {"single": GOLDEN_CHROMS, "multi": 0}),
                                ("borders", ["--pattern", "borders"],
                                 {"single": 0, "multi": GOLDEN_CHROMS})):
        prefix = f"{workdir}/genome_golden_{name}"
        args = parse_args(["detect", "--no-plotting", "--norm", "auto", *flags, "synthetic",
                           prefix], "")

        def run_detect():
            with contextlib.redirect_stdout(io.StringIO()):
                return detect(source, args, DEVICE)

        (table, _), seen = run_genome(f"golden {name}", run_detect, tag="genome-golden")
        n_calls, d_score, d_text, row, d_logp = compare_genome_golden(
            f"tests/data/golden_genome_{name}.tsv", prefix, table)
        print(f"[genome-golden] {name}: {n_calls}/{n_calls} calls of the reference identical "
              f"(bin1, bin2, kernel_id, iteration, chrom/start); score max|d| {d_score:.3g} "
              f"(bound 5e-5); log10 p max|d| {d_logp:.3g} (bound 1e-3) from the unrounded "
              f"p-values to the reference's written decimals, {d_text:.3g} between the written "
              f"p-values (largest at {row}); launches {seen}")
        check(d_score < 5e-5 and d_logp < 1e-3, f"genome-golden {name}: outside the bounds")
        check(seen == expect, f"genome-golden {name}: launches {seen}")


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
    genome = api_genome(EXAMPLE_NPZ, device, kernel_config=config)
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
    g = api_genome(EXAMPLE_NPZ, kernel_config=dict(ck.loops))
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
    print(f"[api] TUTORIAL block on {EXAMPLE_NPZ}: normxcorr2 + pick_foci {len(coords)} "
          f"foci on {cm.name}; pattern_detector(full=True) {len(patterns)} calls, windows "
          f"{windows.shape}; launches {seen}")
    check(seen == {"single": 1, "multi": 0} and len(patterns) == len(windows) > 0,
          "TUTORIAL block")
    cm.destroy_mat()

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
        genome = api_genome(EXAMPLE_NPZ, device, kernel_config=ck.loops)
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
    print(f"[api] notebook loop on {len(per_map)} x {GENOME_BINS} bins with kernels.loops: "
          f"{n_calls} calls, API wall {wall:.2f} s (phase 5's detect wall "
          f"{WALLS['detect loops']:.2f} s, this run's cards {nvidia_smi('name,power.limit')}); "
          f"launches {seen}")
    check(seen == {"single": len(per_map), "multi": 0}, f"API genome launches {seen}")
    for cm, (calls, wins) in zip(genome.sub_mats.contact_map, per_map):
        quietly(cm.create_mat)
        cli_calls, cli_wins = detect_multi(cm, ck.loops, [kernel])[0]
        cm.destroy_mat()
        check(calls.equals(pd.DataFrame(cli_calls)) and np.array_equal(
            wins, cli_wins, equal_nan=True), f"{cm.name}: API calls differ from detect_multi")
    print(f"[api] genome: every map's calls identical to detect_multi's on the same map")

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
        phase_golden(workdir)
        runs = phase_genome(source, workdir)
        phase_surface_example(workdir)
        phase_surface_genome(source, workdir)
        phase_api(source)
        del source
        phase_golden_inter(workdir)
        phase_genome_inter(workdir)
        phase_genome_golden(workdir)
    check("jax" not in sys.modules, "jax was imported")
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
    run(parser.parse_args().quick)
