"""The bench genome: a synthetic multi-chromosome ``.cool`` with planted
loops, written once and cached.

Counterpart of ``tools/make_synthetic_cool.py:74-176`` (the balanced
``.cool`` and its ``.truth.bed2d``) and of ``bench.py:54-88``
(``ensure_genome``).  The genome is ``ArraySource.from_synthetic``,
drawn exactly as the tool draws it and ICE-balanced as the tool balances
it; ``create_cool`` writes it with the port's own HDF5 code (no h5py, no
subprocess).  The cache directory (``CHROMOSIGHT_BENCH_CACHE``, by
default ``chromosight_bench`` in the temporary directory), the file names
(``genome_{bins}x{chroms}.cool``, ``genome_trans_{bins}x{chroms}.cool``
for a genome with trans contacts) and the sizes
(``CHROMOSIGHT_BENCH_GENOME_BINS``, ``_GENOME_CHROMS``,
``_BASELINE_BINS``) are ``bench.py``'s.
"""

from __future__ import annotations

import os
import pathlib
import tempfile

from chromosight_torch.io.cool import bins_frame, create_cool
from chromosight_torch.io.source import ArraySource

MAX_DIST = 400  # loops config: 2 Mb at 5 kb
BINSIZE = 5000
# the BASELINE 5c genome: trans contacts at 1e-3 of each trans pair's cells
TRANS_DENSITY = 1e-3


def sizes():
    """(genome bins, chromosomes, baseline bins) of the bench: the
    ``CHROMOSIGHT_BENCH_*`` variables, by default the 624,000-bin human
    5 kb shape (13 x 48,000) and a 5,000-bin baseline slice."""
    env = os.environ
    return (
        int(env.get("CHROMOSIGHT_BENCH_GENOME_BINS", 624_000)),
        int(env.get("CHROMOSIGHT_BENCH_GENOME_CHROMS", 13)),
        int(env.get("CHROMOSIGHT_BENCH_BASELINE_BINS", 5000)),
    )


def cache_dir():
    """The directory the bench genomes are cached in."""
    default = os.path.join(tempfile.gettempdir(), "chromosight_bench")
    return pathlib.Path(os.environ.get("CHROMOSIGHT_BENCH_CACHE", default))


def genome_path(chroms, bins, trans_density=0.0):
    """The cache path of the genome of ``chroms`` chromosomes of ``bins``
    bins (with trans contacts when ``trans_density`` > 0)."""
    kind = "genome_trans" if trans_density else "genome"
    return cache_dir() / f"{kind}_{bins}x{chroms}.cool"


def truth_path(path):
    """The planted loops' bed2d file beside the genome at ``path``."""
    return pathlib.Path(f"{path}.truth.bed2d")


def write_truth(source, path):
    """``source.planted`` as the tool's headerless bed2d (one-bin anchors,
    genomic coordinates)."""
    size = source.binsize
    with open(path, "w") as handle:
        for chrom, i, j in source.planted:
            handle.write(f"{chrom}\t{i * size}\t{(i + 1) * size}\t"
                         f"{chrom}\t{j * size}\t{(j + 1) * size}\n")


def write_genome(source, path):
    """Write a synthetic ``source`` (``ArraySource.from_synthetic``) as the
    ``.cool`` at ``path``, its weights included, and its planted loops
    beside it.  The truth file is written first and the ``.cool`` renamed
    into place last, so a ``.cool`` at ``path`` always has its truth."""
    path = pathlib.Path(path)
    write_truth(source, truth_path(path))
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    pixels = {"bin1_id": source.bin1, "bin2_id": source.bin2, "count": source.count}
    try:
        create_cool(str(tmp), bins_frame(source), pixels, metadata={"synthetic": True})
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def ensure_genome(chroms=None, bins=None, trans_density=0.0, seed=0):
    """The path of the cached genome, generated and written on first use:
    ``chroms`` chromosomes of ``bins`` bins (by default the bench's
    ``sizes()``: its genome bins split over its chromosomes), seed
    ``seed``, trans contacts at ``trans_density``."""
    if chroms is None or bins is None:
        genome_bins, genome_chroms, _ = sizes()
        chroms = genome_chroms if chroms is None else chroms
        bins = genome_bins // genome_chroms if bins is None else bins
    path = genome_path(chroms, bins, trans_density)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        source = ArraySource.from_synthetic(
            chroms, bins, seed=seed, binsize=BINSIZE, trans_density=trans_density
        )
        write_genome(source, path)
    return path
