"""The port's CLI detect against the reference-generated goldens of the
single-option configs (tests/test_golden_outputs.py:70-121), from the
npz export of data_test/example.cool, on CPU."""

import contextlib
import io
import pathlib

import numpy as np
import pandas as pd
import pytest

from chromosight_torch.cli.main import main
from torch_parity import torch_one_thread  # noqa: F401

DATA = pathlib.Path(__file__).parent / "data"


@pytest.mark.parametrize(
    "golden,flags",
    [
        ("golden_detect_loops_iter2", ["--iterations", "2"]),
        ("golden_detect_loops_win21", ["--win-size", "21"]),
        ("golden_detect_loops_small", ["--pattern", "loops_small"]),
        ("golden_detect_hairpins", ["--pattern", "hairpins"]),
        ("golden_detect_stripes_left", ["--pattern", "stripes_left"]),
        ("golden_detect_stripes_right", ["--pattern", "stripes_right"]),
        ("golden_detect_borders", ["--pattern", "borders"]),
        ("golden_detect_loops_maxdist", ["--max-dist", "100000"]),
        ("golden_detect_loops_mindist", ["--min-dist", "40000"]),
        ("golden_detect_loops_perczero", ["--perc-zero", "5"]),
        ("golden_detect_loops_percundetected", ["--perc-undetected", "20"]),
    ],
)
def test_detect_flag_configs_match_reference(tmp_path, golden, flags):
    """Exact (bin1, bin2, kernel, iteration) calls; scores within 5e-5
    and p-values within 1e-5 of the reference's fp64 values."""
    prefix = str(tmp_path / "out")
    with contextlib.redirect_stderr(io.StringIO()):
        rc = main(
            ["detect", "--no-plotting", *flags, str(DATA / "example_cool.npz"), prefix],
            device="cpu",
        )
    assert rc == 0
    g = pd.read_csv(DATA / f"{golden}.tsv", sep="\t")
    o = pd.read_csv(prefix + ".tsv", sep="\t")
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(o) == len(g)
    assert set(map(tuple, o[key].values)) == set(map(tuple, g[key].values))
    m = g.merge(o, on=key, suffixes=("_ref", "_port"))
    assert np.abs(m.score_ref - m.score_port).max() < 5e-5
    assert np.abs(m.pvalue_ref - m.pvalue_port).max() < 1e-5
    if golden == "golden_detect_loops_iter2":
        assert (o.iteration == 1).sum() > 0
