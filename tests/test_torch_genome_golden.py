"""The port's genome-scale calls against the reference's own.

``tests/data/golden_genome_{loops,borders}.tsv`` hold the calls the
reference's ``cmd_detect`` made on the seed-0 synthetic genome of
``tools/make_synthetic_cool.py --bins 50000 --chroms 3`` at ``--norm auto``
(``tests/data/golden_genome_meta.json``; the JAX package is held to them
by tests/test_golden_genome_scale.py).  Here the port builds the same
genome in memory (``ArraySource.from_synthetic(3, 50000, seed=0)``), checks
its fingerprint against the goldens' record, runs its ``detect`` on the
CPU, and is held to what tests/test_golden_genome_scale.py:121-134
requires: the same (bin1, bin2, kernel_id, iteration) calls and
coordinates, score max|d| < 5e-5 and log10 p max|d| < 1e-3 between the
written p-values; and log10 p max|d| < 1e-3 from the run's unrounded
p-values to the reference's written decimals, the form chip_smoke.py's
genome-golden phase holds the card to (ten decimals leave two or three
significant digits near 1e-8, where one rounding flip of the last digit
is 1.07e-3 in log10 p).

Marked slow: generating the 76-million-pixel genome and two genome-wide
band scans on the CPU take minutes.
"""

import json
import pathlib

import numpy as np
import pandas as pd
import pytest

from chromosight_torch.cli.args import parse_args
from chromosight_torch.cli.main import detect
from chromosight_torch.io.source import ArraySource
from torch_parity import torch_one_thread  # noqa: F401

DATA = pathlib.Path(__file__).parent / "data"

pytestmark = pytest.mark.slow


def source_fingerprint(source):
    """tests/test_golden_genome_scale.py:45-58 on a source's counts in
    cool pixel order (bin1, then bin2): the pixel count and the sum of
    every ``n // 4096``-th count, 4096 of them."""
    order = np.lexsort((source.bin2, source.bin1))
    if not np.array_equal(order, np.arange(len(order))):
        counts = source.count[order]
    else:
        counts = source.count
    n = len(counts)
    sample = counts[:: max(n // 4096, 1)][:4096]
    return {"nnz": int(n), "checksum": int(np.asarray(sample, np.int64).sum())}


@pytest.fixture(scope="module")
def genome():
    meta = json.loads((DATA / "golden_genome_meta.json").read_text())
    source = ArraySource.from_synthetic(3, 50000, seed=0)
    assert source_fingerprint(source) == meta["fingerprint"]
    return source


def compare_with_golden(golden, ours, table):
    """tests/test_golden_genome_scale.py:121-134 on two call tables (the
    files as written), after its exact checks: (score max|d|, log10 p
    max|d| between the written p-values, log10 p max|d| from the run's
    unrounded p-values in ``table`` to the interval the reference's
    written decimal stands for)."""
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    g = golden.sort_values(key).reset_index(drop=True)
    o = ours.sort_values(key).reset_index(drop=True)
    exact = pd.DataFrame({k: table[k] for k in key + ["pvalue"]})
    exact = exact.sort_values(key).reset_index(drop=True)
    assert len(o) == len(g), f"{len(o)} calls vs the reference's {len(g)}"
    for col in key + ["chrom1", "start1", "chrom2", "start2"]:
        assert (g[col] == o[col]).all(), f"column {col} differs"
    assert exact[key].equals(o[key])

    def log10(p):
        return np.log10(np.maximum(p, 1e-300))

    nearest = np.clip(exact.pvalue, g.pvalue - 5e-11, g.pvalue + 5e-11)
    return (
        float(np.abs(g.score - o.score).max()),
        float(np.abs(log10(g.pvalue) - log10(o.pvalue)).max()),
        float(np.abs(log10(exact.pvalue) - log10(nearest)).max()),
    )


@pytest.mark.parametrize("name,flags", [("loops", []), ("borders", ["--pattern", "borders"])])
def test_genome_calls_match_reference(genome, tmp_path, name, flags):
    prefix = str(tmp_path / name)
    args = parse_args(["detect", "--no-plotting", "--norm", "auto", *flags, "g", prefix], "")
    table, _ = detect(genome, args, device="cpu")
    golden = pd.read_csv(DATA / f"golden_genome_{name}.tsv", sep="\t")
    ours = pd.read_csv(prefix + ".tsv", sep="\t")
    score, logp_text, logp = compare_with_golden(golden, ours, table)
    assert score < 5e-5
    assert logp_text < 1e-3
    assert logp < 1e-3
