#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (chromosight_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py            # all phases; last line is the result
    python3 chip_smoke.py --quick    # env, build and small kernel checks only

Phases, one line or block each; any failure raises (non-zero exit):

1. env      torch and CUDA versions, nvidia-smi's driver_version, the card,
            optional packages;
2. build    nvcc build of chromosight_torch/csrc/*.cu for sm_90a;
3. kernels  the CUDA band Pearson against its plain PyTorch twin on the
            card, on random bands (tests/test_pallas.py shapes, the 81x81
            centromeres kernel) and on one 48,000-row chromosome of the
            synthetic genome; device times of both at that shape;
4. golden   ``detect`` on tests/data/example_cool.npz reproduces the 89
            calls of tests/data/golden_detect_loops.tsv;
5. genome   ``detect`` (loops) on a synthetic 13 x 48,000-bin genome at
            5 kb (the bench.py shape), recall of the planted loops.

It prints the kernel table and the card's ``nvidia-smi`` name and power
limit, then ``{"ok": true, "device": {...}}`` as its last line.  Without a
CUDA card, or outside the repository, it exits non-zero and prints no
result.
"""

import argparse
import csv
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card")

import chromosight_torch.ops.band_pearson as bp  # noqa: E402
from chromosight_torch.cli.main import detect, main, parse_args  # noqa: E402
from chromosight_torch.detection import frame_contact_map  # noqa: E402
from chromosight_torch.device import reset_stages, stage_seconds  # noqa: E402
from chromosight_torch.io.config import load_kernel_config  # noqa: E402
from chromosight_torch.io.source import (  # noqa: E402
    ArraySource,
    native_scatter_available,
    planted_recall,
)
from chromosight_torch.ops import _build  # noqa: E402
from chromosight_torch.ops.band import band_frame, pearson_reference  # noqa: E402
from chromosight_torch.runtime.genome import HicGenome  # noqa: E402

GENOME_CHROMS, GENOME_BINS, BINSIZE = 13, 48_000, 5000
MISSING_TOL, PEARSON = 0.5, 0.3
DEVICE = torch.device("cuda")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi(query):
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def phase_env():
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} driver_version {nvidia_smi('driver_version')}")
    print(f"[env] {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")
    imports = {}
    for name in ("triton", "h5py", "pandas", "jsonschema", "jax"):
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
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


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


def random_case(kernel, n, n_pad, rng):
    """A tests/test_pallas.py band (40% filled, rows 3, 77, 200 missing),
    framed on the card: (sig_p, mask_p, max_dist)."""
    mk, nk = kernel.shape
    max_dist = 40
    width = max_dist + max(mk, nk) + 1
    band = (rng.rand(n_pad, width) * (rng.rand(n_pad, width) < 0.4)).astype(np.float32)
    band[n:] = 0
    miss = np.zeros(n_pad, bool)
    miss[[3, 77, 200]] = True
    band[miss] = 0
    sig_p, mask_p = band_frame(
        torch.from_numpy(band).to(DEVICE), torch.from_numpy(miss).to(DEVICE),
        kernel.shape, n, max_dist,
    )
    return sig_p, mask_p, max_dist


def run_both(name, sig_p, mask_p, kernel, n, max_dist, pearson=PEARSON):
    """Kernel and plain twin on the same framed inputs; returns the corr
    error and the argument tuple after the inputs."""
    args = (kernel, n, max_dist, MISSING_TOL, pearson)
    got = bp.band_pearson(sig_p, mask_p, *args)
    ref = pearson_reference(sig_p, mask_p, *args)
    torch.cuda.synchronize()
    return compare(name, ref, got, n, max_dist, pearson), args


def device_ms(fn, reps=5):
    """Median device time of ``fn()`` over ``reps`` calls after a warm one."""
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


def phase_kernels_small():
    errs = []
    for preset in ("loops_small", "loops"):
        kernel = np.asarray(load_kernel_config(preset)["kernels"][0], np.float32)
        case = random_case(kernel, 300, 512, np.random.RandomState(0))
        errs.append(run_both(f"{preset} n_pad=512", *case[:2], kernel, 300, case[2])[0])
    for shape in ((5, 9), (3, 17)):
        rng = np.random.RandomState(11)
        kernel = (rng.rand(*shape) + 0.1).astype(np.float32)
        case = random_case(kernel, 300, 512, rng)
        errs.append(run_both(f"{shape} n_pad=512", *case[:2], kernel, 300, case[2])[0])
    cfg = load_kernel_config("centromeres")
    kernel = cfg["kernels"][0]
    case = random_case(kernel, 400, 400, np.random.RandomState(2))
    errs.append(run_both("centromeres 81x81 n=400", *case[:2], kernel, 400, case[2],
                         cfg["pearson"])[0])
    return max(errs)


def phase_kernels_chromosome(source):
    """Kernel vs plain, and both device times, on chr1 of the genome, on
    the framed inputs the main path gives the kernel."""
    cfg = load_kernel_config("loops")
    genome = HicGenome(source, cfg, DEVICE)
    genome.normalize("auto")
    genome.make_sub_matrices()
    cm = genome.sub_mats[0].contact_map
    cm.create_mat()
    kernel = cfg["kernels"][0]
    sig_p, mask_p = frame_contact_map(cm, kernel.shape)
    err, args = run_both(
        f"loops {cm.name} {tuple(cm.band.shape)}", sig_p, mask_p, kernel,
        cm.shape[0], cm.max_dist,
    )
    kernel_ms = device_ms(lambda: bp.band_pearson(sig_p, mask_p, *args))
    plain_ms = device_ms(lambda: pearson_reference(sig_p, mask_p, *args))
    print(f"[kernels] device time at {tuple(cm.band.shape)}, loops 17x17 "
          f"(median of 5, CUDA events): kernel {kernel_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    cm.destroy_mat()
    return err, kernel_ms, plain_ms


def read_tsv(path):
    with open(path) as handle:
        return list(csv.DictReader(handle, delimiter="\t"))


def phase_golden(workdir):
    launches = bp.LAUNCHES
    prefix = f"{workdir}/golden"
    check(main(["detect", "--no-plotting", "tests/data/example_cool.npz", prefix],
               device=DEVICE) == 0, "golden detect failed")
    ours = {(r["chrom1"], r["bin1"], r["bin2"]): r for r in read_tsv(prefix + ".tsv")}
    golden = {(r["chrom1"], r["bin1"], r["bin2"]): r
              for r in read_tsv("tests/data/golden_detect_loops.tsv")}
    check(len(golden) == 89 and ours.keys() == golden.keys(),
          f"calls differ from the golden: {len(ours)} vs {len(golden)}")
    err = {c: max(abs(float(ours[k][c]) - float(golden[k][c])) for k in golden)
           for c in ("score", "pvalue", "qvalue")}
    grown = bp.LAUNCHES - launches
    print(f"[golden] 89/89 calls identical; max|d| score {err['score']:.3g}, "
          f"pvalue {err['pvalue']:.3g}, qvalue {err['qvalue']:.3g}; launches +{grown}")
    check(err["score"] < 5e-5 and err["pvalue"] < 1e-6 and err["qvalue"] < 1e-6,
          f"golden scores differ: {err}")
    check(grown == 3, f"expected 3 kernel launches, saw {grown}")


def phase_genome(source, workdir):
    prefix = f"{workdir}/genome"
    args = parse_args(["detect", "--no-plotting", "synthetic", prefix], "")
    reset_stages()
    torch.cuda.reset_peak_memory_stats()
    bp.LAUNCHES = 0
    t0 = time.perf_counter()
    table, _ = detect(source, args, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = bp.LAUNCHES
    stages = stage_seconds()
    recall = planted_recall(source, table)
    n_chroms = len(source.chromnames)
    print(f"[genome] {n_chroms} x {GENOME_BINS} bins, loops: wall {wall:.2f} s, "
          f"{len(table['bin1'])} calls, recall {recall:.4f} "
          f"({len(source.planted)} planted, +-2 bins), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {launches}")
    print("[genome] stages (s): " + json.dumps({k: round(v, 3) for k, v in sorted(stages.items())}))
    check(launches == n_chroms, f"expected {n_chroms} kernel launches, saw {launches}")
    check(recall >= 0.95, f"recall {recall} below 0.95")
    check(all(np.isfinite(table["score"])) and all(np.isfinite(table["pvalue"])),
          "non-finite scores")
    return launches


def run(quick):
    phase_env()
    phase_build()
    max_err = phase_kernels_small()
    if quick:
        print("[quick] env, build and small kernel checks passed")
        return
    t0 = time.perf_counter()
    source = ArraySource.from_synthetic(GENOME_CHROMS, GENOME_BINS, seed=0, binsize=BINSIZE)
    print(f"[genome] synthetic genome {GENOME_CHROMS} x {GENOME_BINS} bins, "
          f"{source.nnz} pixels, generated and balanced in "
          f"{time.perf_counter() - t0:.1f} s")
    err, kernel_ms, plain_ms = phase_kernels_chromosome(source)
    max_err = max(max_err, err)
    with tempfile.TemporaryDirectory() as workdir:
        phase_golden(workdir)
        launches = phase_genome(source, workdir)
    check("jax" not in sys.modules, "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "band_pearson",
        "route": "cuda",
        "source": "chromosight_torch/csrc/band_pearson.cu",
        "replaces": "chromosight_tpu/ops/pallas_band.py:31",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
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
