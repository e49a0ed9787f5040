#!/usr/bin/env python3
"""Profile the tiled sparse engine of chromosight_torch on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 profile_tiled.py

It prints, one block each:

1. cuDNN's float64 and float32 17x17 ``conv2d`` and the float64 window
   sum (two one-dimensional passes) on (B, 1, 2064, 2064) stacks, the
   blocks of tiles of 2048: CUDA-event ms per call;
2. ``normxcorr2_sparse_tiled`` on a random 8,192 x 16,384 map with 1e-3
   of its cells stored and 2% of its bins missing (the crossing mask of
   an inter map, detect mode: ``keep_min`` 0.3), at several tile sizes and
   batch sizes, with the window sums by scatter-add of the entries (the
   default for such maps) and by ``conv2d`` (``SCATTER_DENSITY`` 0): wall
   seconds and peak device memory;
3. the ``torch.profiler`` table of one default call: device time per op.
"""

import statistics
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("profile_tiled: torch.cuda.is_available() is False; this needs a CUDA card")

import scipy.sparse as sp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chromosight_torch.observability as observability  # noqa: E402
import chromosight_torch.ops.tiled as tiled  # noqa: E402
from chromosight_torch.io.config import load_kernel_config  # noqa: E402

DEVICE = torch.device("cuda")
SHAPE, DENSITY, MISSING = (8192, 16384), 1e-3, 0.02


def event_ms(fn, reps=3):
    """Median CUDA-event time of ``fn()`` after a warm call."""
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


def convolutions():
    for b in (1, 8):
        x = torch.rand(b, 1, 2064, 2064, device=DEVICE, dtype=torch.float64)
        w = torch.rand(1, 1, 17, 17, device=DEVICE, dtype=torch.float64)
        rows, cols = x.new_ones((1, 1, 17, 1)), x.new_ones((1, 1, 1, 17))
        t64 = event_ms(lambda: F.conv2d(x, w))
        x32, w32 = x.float(), w.float()
        t32 = event_ms(lambda: F.conv2d(x32, w32))
        tws = event_ms(lambda: F.conv2d(F.conv2d(x, rows), cols))
        print(f"[conv] B={b} (B, 1, 2064, 2064): 17x17 conv2d float64 {t64:.3f} ms, "
              f"float32 {t32:.3f} ms; float64 17x17 window sum {tws:.3f} ms")


def sparse_case():
    rng = np.random.RandomState(0)
    m = int(DENSITY * SHAPE[0] * SHAPE[1])
    rows, cols = rng.randint(0, SHAPE[0], m), rng.randint(0, SHAPE[1], m)
    vals = rng.rand(m).astype(np.float32) + 0.5
    mat = sp.coo_matrix((vals, (rows, cols)), shape=SHAPE).tocsr()
    return mat, rng.rand(SHAPE[0]) < MISSING, rng.rand(SHAPE[1]) < MISSING


def main():
    print(f"[env] torch {torch.__version__}, {torch.cuda.get_device_name(0)}")
    convolutions()
    kernel = np.asarray(load_kernel_config("loops")["kernels"][0])
    mat, miss_r, miss_c = sparse_case()

    def scan():
        return tiled.normxcorr2_sparse_tiled(
            mat, kernel, full=True, missing_vectors=(miss_r, miss_c), missing_tol=0.5,
            pval=True, keep_min=0.3, device=DEVICE,
        )

    scan()
    torch.cuda.synchronize()
    defaults = tiled.DEFAULT_TILE, tiled.TILE_BATCH, tiled.SCATTER_DENSITY
    for tile, batch, density in (
        (2048, 8, defaults[2]), (2048, 4, defaults[2]), (1024, 32, defaults[2]),
        (4096, 2, defaults[2]), (2048, 8, 0.0), (2048, 8, defaults[2]),
    ):
        tiled.DEFAULT_TILE, tiled.TILE_BATCH, tiled.SCATTER_DENSITY = tile, batch, density
        observability.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scan()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[scan] {SHAPE[0]}x{SHAPE[1]} at {DENSITY:g}: tile {tile}, batch {batch}, "
              f"window sums by {'scatter-add' if density else 'conv2d'}: {wall:.3f} s, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
              f"{observability.counters()}")
    tiled.DEFAULT_TILE, tiled.TILE_BATCH, tiled.SCATTER_DENSITY = defaults
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scan()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25,
                                    max_name_column_width=60))


if __name__ == "__main__":
    main()
