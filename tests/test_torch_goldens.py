"""The port's CLI detect against the reference-generated goldens of the
single-option configs (tests/test_golden_outputs.py:70-121), and its
--dump snapshots against tests/data/golden_dump
(tests/test_golden_outputs.py:268-330), from data_test/example.cool read
through the port's own HDF5 reader, on CPU.  Borders (three 17x17 kernels) runs
through the fused K-kernel launch."""

import contextlib
import io
import pathlib

import numpy as np
import pandas as pd
import pytest

from chromosight_torch.cli.main import main
from torch_parity import torch_one_thread  # noqa: F401

DATA = pathlib.Path(__file__).parent / "data"
EXAMPLE_COOL = str(pathlib.Path(__file__).parents[1] / "data_test" / "example.cool")


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
        ("golden_detect_loops_smooth", ["--smooth-trend"]),
        ("golden_detect_loops_tsvd", ["--tsvd"]),
        ("golden_detect_loops_raw", ["--norm", "raw"]),
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
            ["detect", "--no-plotting", *flags, EXAMPLE_COOL, prefix],
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


def test_detect_windows_match_reference(tmp_path):
    """The windows of ``detect --win-fmt json`` against the reference's
    own (tests/data/golden_detect_loops.json, as
    tests/test_golden_outputs.py:235-265 compares them): matched by
    (bin1, bin2), the same NaN pattern, values within rtol 1e-5 and
    atol 1e-6."""
    import json

    prefix = str(tmp_path / "out")
    with contextlib.redirect_stderr(io.StringIO()):
        rc = main(
            ["detect", "--no-plotting", "--win-fmt", "json",
             EXAMPLE_COOL, prefix],
            device="cpu",
        )
    assert rc == 0
    golden_tsv = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    with open(DATA / "golden_detect_loops.json") as fh:
        golden_wins = json.load(fh)
    ours_tsv = pd.read_csv(prefix + ".tsv", sep="\t")
    with open(prefix + ".json") as fh:
        ours_wins = json.load(fh)
    assert len(ours_wins) == len(golden_wins) == 89
    ours_idx = {(r.bin1, r.bin2): i for i, r in enumerate(ours_tsv.itertuples())}
    for gi, grow in enumerate(golden_tsv.itertuples()):
        oi = ours_idx[(grow.bin1, grow.bin2)]
        g = np.asarray(golden_wins[str(gi)], dtype=np.float64)
        o = np.asarray(ours_wins[str(oi)], dtype=np.float64)
        assert g.shape == o.shape == (17, 17)
        assert np.array_equal(np.isnan(g), np.isnan(o)), (gi, oi)
        assert np.allclose(g, o, rtol=1e-5, atol=1e-6, equal_nan=True), (gi, oi)


def test_detect_dump_snapshots_match_reference(tmp_path):
    """Every stage snapshot of --dump against the reference's own npz
    dumps, compared as tests/test_golden_outputs.py:268-330 does: the
    foci labels exactly, the detrended and trimmed maps (upper triangle,
    NaN at the missing bins) within rtol 1e-5 / atol 1e-6, the 03
    snapshot equal to the 04 one, and 04 within 2e-4 of the reference."""
    import scipy.sparse as sp

    golden_dir = DATA / "golden_dump"
    dumpdir = tmp_path / "dumps"
    prefix = str(tmp_path / "out")
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(
        io.StringIO()
    ):
        rc = main(
            [
                "detect", "--no-plotting", "--iterations", "1", "--dump",
                str(dumpdir), EXAMPLE_COOL, prefix,
            ],
            device="cpu",
        )
    assert rc == 0
    names = sorted(p.name for p in golden_dir.glob("*.npz"))
    assert len(names) == 15
    assert sorted(p.name for p in dumpdir.glob("*.npz")) == names
    for name in names:
        ref = sp.load_npz(golden_dir / name).toarray()
        ours = sp.load_npz(dumpdir / name).toarray()
        assert ours.shape == ref.shape, name
        if "_05_foci" in name:
            assert np.array_equal(ours, ref), name
        elif "_01_detrended" in name or "_02_remove_diags" in name:
            o_t, r_t = np.triu(ours), np.triu(ref)
            assert np.array_equal(np.isnan(o_t), np.isnan(r_t)), name
            o_t, r_t = np.nan_to_num(o_t), np.nan_to_num(r_t)
            assert np.allclose(o_t, r_t, rtol=1e-5, atol=1e-6), name
            if "_02_" in name:
                assert not np.nan_to_num(np.tril(ref, -1)).any(), name
        elif "_03_normxcorr2" in name:
            ours04 = sp.load_npz(
                dumpdir / name.replace("_03_normxcorr2", "_04_diag_trim")
            ).toarray()
            assert np.array_equal(ours, ours04), name
        else:
            assert np.array_equal(np.isnan(ours), np.isnan(ref)), name
            assert np.max(np.abs(np.nan_to_num(ours) - np.nan_to_num(ref))) < 2e-4, name
