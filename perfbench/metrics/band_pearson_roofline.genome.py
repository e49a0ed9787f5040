"""The band Pearson kernel's share of its roofline, in percent: the least
time the card could take for the work the inputs need, over the kernel's
device time in the profiler's trace (``ops/band_pearson.py``,
``csrc/band_pearson.cu``).

The work is counted by the benchmark from the genome, not by the
program, so it does not depend on what implements the kernel
(``reference.band_pearson``, one entry per launch of a command): for K
kernels of mk x nk taps, each non-zero pixel of the framed signal takes
mk nk K FMAs (one product with each kernel) and each set bit of the
framed missing mask mk nk 2K (with each kernel and its square); the
window's box sums of the signal, its square and the mask need no
multiplication and are left out (a prefix sum takes O(1) adds a pixel
for them), so no implementation can do less than is counted; the bytes are the float32 band and the missing flags read once and
the float32 corr and log10 p and one candidate byte per pixel and kernel
written once.  A launch's least time is the larger of its FMAs at the
card's FP64 tensor-core rate and its bytes at its memory rate
(``peaks.json``)."""

UNIT = "%"
LAYER = "band Pearson kernel"
MOVES = "genome_cmd_s"
KERNEL = "band_pearson"


def read(run):
    if run.trace is None or not run.peaks or not run.work.get("band_launches"):
        return None
    kernel_s = sum(s for name, s in run.trace["kernel_s"].items() if KERNEL in name)
    if kernel_s <= 0 or not run.commands:
        return None
    least = sum(max(fma / run.peaks["fma_per_s"], nbytes / run.peaks["bytes_per_s"])
                for fma, nbytes in run.work["band_launches"])
    return 100.0 * run.commands * least / kernel_s
