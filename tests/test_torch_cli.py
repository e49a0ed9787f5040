"""The port's CLI surface on CPU against the JAX package's: ICE balancing
(``--norm force``, maps without weights, ``--n-mads``), ``--subsample``
(its draws, its calls and its ``01_subsampled`` snapshots), and the
``generate-config`` (``--click`` too), ``list-kernels`` and ``test``
subcommands."""

import contextlib
import io
import os
import pathlib
import shutil

import h5py
import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import chromosight_torch.cli.main as tcli
import chromosight_tpu.cli.main as jcli
import chromosight_tpu.kernels as ck
from chromosight_torch.io.config import load_kernel_config
from chromosight_torch.io.source import ArraySource
from chromosight_torch.preprocessing import subsample_contacts
from chromosight_torch.runtime.genome import HicGenome
from chromosight_tpu.preprocessing import subsample_contacts as j_subsample_contacts
from chromosight_tpu.runtime.genome import HicGenome as JaxHicGenome
from torch_parity import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
EXAMPLE_COOL = ROOT / "data_test" / "example.cool"
EXAMPLE_NPZ = ROOT / "tests" / "data" / "example_cool.npz"
# the JAX package's single-device, serial order (its own switches; the
# tests' 8-device CPU mesh would take the mesh path)
JAX_SERIAL = {
    "CHROMOSIGHT_TPU_PREFETCH": "0",
    "CHROMOSIGHT_TPU_DETECT_PIPELINE": "1",
    "CHROMOSIGHT_TPU_MESH": "0",
}


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def assert_calls_match(ours, ref):
    """Identical coordinates; scores within 5e-5, p and q within 1e-5."""
    a, b = pd.read_csv(ours, sep="\t"), pd.read_csv(ref, sep="\t")
    assert len(a) == len(b) > 0
    for col in ("chrom1", "start1", "chrom2", "start2", "bin1", "bin2"):
        assert (a[col] == b[col]).all(), col
    assert np.abs(a.score - b.score).max() < 5e-5
    assert np.abs(a.pvalue - b.pvalue).max() < 1e-5
    assert np.abs(a.qvalue - b.qvalue).max() < 1e-5


def test_norm_force_matches_jax(tmp_path):
    """``--norm force`` on copies of example.cool: the stored weights
    equal the JAX package's bit for bit (same thread, so the same thread
    count), with the same stats attributes, and so do the calls."""
    ours, ref = tmp_path / "ours.cool", tmp_path / "ref.cool"
    shutil.copy(EXAMPLE_COOL, ours)
    shutil.copy(EXAMPLE_COOL, ref)
    argv = ["detect", "--no-plotting", "--norm", "force"]
    assert quiet(tcli.main, [*argv, str(ours), str(tmp_path / "t")], device="cpu") == 0
    assert quiet(jcli.main, [*argv, str(ref), str(tmp_path / "j")]) == 0
    with h5py.File(ours, "r") as a, h5py.File(ref, "r") as b:
        wa, wb = a["bins/weight"], b["bins/weight"]
        assert wa[:].tobytes() == wb[:].tobytes()
        assert dict(wa.attrs) == dict(wb.attrs) and len(wa.attrs) == 3
        assert np.isfinite(wa[:]).sum() > 600
    assert_calls_match(tmp_path / "t.tsv", tmp_path / "j.tsv")


@pytest.mark.parametrize("n_mads", ["3", "5"])
def test_map_without_weights_balances_first(tmp_path, n_mads):
    """An ``ArraySource`` without weights at ``--norm auto`` is balanced
    (ICE on the host) before the scan, and gives the detectable bins the
    JAX package gives a cool file without its weight column; detect then
    runs on the balanced map."""
    cool = tmp_path / "noweight.cool"
    shutil.copy(EXAMPLE_COOL, cool)
    with h5py.File(cool, "r+") as f:
        del f["bins/weight"]
    src = ArraySource.from_npz(EXAMPLE_NPZ)
    src._weight = None
    cfg = load_kernel_config("loops")
    genome = HicGenome(src, kernel_config=cfg, device=torch.device("cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        genome.normalize("auto", float(n_mads))
        ref = JaxHicGenome(str(cool), kernel_config=dict(ck.loops))
        ref.normalize(norm="auto", n_mads=float(n_mads))
    assert "Whole genome matrix balanced" in out.getvalue()
    assert np.array_equal(genome.detectable_bins, ref.detectable_bins)
    assert src.weights is not None and np.isfinite(src.weights).sum() == len(ref.detectable_bins)
    if n_mads == "3":
        npz = tmp_path / "noweight.npz"
        src._weight = None
        src.to_npz(npz)
        argv = ["detect", "--no-plotting", "--n-mads", n_mads]
        assert quiet(tcli.main, [*argv, str(npz), str(tmp_path / "t")], device="cpu") == 0
        assert quiet(jcli.main, [*argv, str(cool), str(tmp_path / "j")]) == 0
        assert_calls_match(tmp_path / "t.tsv", tmp_path / "j.tsv")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subsample_contacts_matches_jax(seed):
    """The draws from ``RandomState(seed)`` equal the JAX package's after
    ``np.random.seed(seed)``, exactly."""
    rng = np.random.RandomState(100 + seed)
    mat = sp.random(80, 90, density=0.2, random_state=rng, format="coo")
    mat.data = np.round(mat.data * 30) + 1
    n = int(0.6 * mat.data.sum())
    ours = subsample_contacts(mat, n, np.random.RandomState(seed))
    np.random.seed(seed)
    ref = j_subsample_contacts(mat, n)
    assert ours.data.sum() == n
    assert np.array_equal(ours.row, ref.row) and np.array_equal(ours.col, ref.col)
    assert np.array_equal(ours.data, ref.data)


def test_detect_subsample_matches_jax(tmp_path, monkeypatch):
    """``detect --subsample 0.8`` from the npz with ``RandomState(0)``
    against the JAX CLI run serially after ``np.random.seed(0)``: the
    same calls, and the same ``01_subsampled`` snapshots (NaN where the
    JAX package has NaN)."""
    for name, value in JAX_SERIAL.items():
        monkeypatch.setenv(name, value)
    argv = ["detect", "--no-plotting", "--subsample", "0.8"]
    ours, ref = tmp_path / "tdump", tmp_path / "jdump"
    assert quiet(
        tcli.main, [*argv, "--dump", str(ours), str(EXAMPLE_NPZ), str(tmp_path / "t")],
        device="cpu", rng=np.random.RandomState(0),
    ) == 0
    np.random.seed(0)
    assert quiet(
        jcli.main, [*argv, "--dump", str(ref), str(EXAMPLE_COOL), str(tmp_path / "j")]
    ) == 0
    assert_calls_match(tmp_path / "t.tsv", tmp_path / "j.tsv")
    names = sorted(p.name for p in ref.glob("*_01_subsampled.npz"))
    assert len(names) == 3
    assert sorted(p.name for p in ours.iterdir()) == sorted(p.name for p in ref.iterdir())
    for name in names:
        a, b = sp.load_npz(ours / name), sp.load_npz(ref / name)
        assert a.dtype == b.dtype and a.nnz == b.nnz > 0
        assert np.array_equal(a.toarray(), b.toarray(), equal_nan=True)


def test_subsample_redraws_and_refusals(tmp_path):
    """Two runs with one seed agree and another seed differs; a number of
    contacts above 1 is a share of the map's total, and values above the
    total skip subsampling, as in the JAX package."""
    src = ArraySource.from_npz(EXAMPLE_NPZ)
    cfg = load_kernel_config("loops")
    total = src.info["sum"]
    assert total == float(src.count.sum()) > 0
    assert HicGenome(src, kernel_config=cfg, sample=str(total / 2), device="cpu").sample == 0.5
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert HicGenome(src, kernel_config=cfg, sample=2 * total, device="cpu").sample is None
    assert "skipping subsampling" in out.getvalue()
    with pytest.raises(ValueError, match="positive"):
        HicGenome(src, kernel_config=cfg, sample="-1", device="cpu")
    tables = []
    for seed in (3, 3, 4):
        prefix = str(tmp_path / f"s{len(tables)}")
        quiet(tcli.main, ["detect", "--no-plotting", "--subsample", "0.7", str(EXAMPLE_NPZ),
                          prefix], device="cpu", rng=np.random.RandomState(seed))
        tables.append(pathlib.Path(prefix + ".tsv").read_bytes())
    assert tables[0] == tables[1] != tables[2]


@pytest.mark.parametrize("flags", [["--preset", "borders"], ["-W", "9"]],
                         ids=["borders", "win9"])
def test_generate_config_byte_identical(tmp_path, monkeypatch, flags):
    """``generate-config`` writes the JAX package's files byte for byte
    (the same relative prefix in two directories)."""
    for tag, run in (("t", tcli.main), ("j", jcli.main)):
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        assert quiet(run, ["generate-config", *flags, "cfg"]) == 0
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "cfg.json" in names and "cfg.1.txt" in names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    monkeypatch.chdir(tmp_path / "t")
    cfg = load_kernel_config("cfg.json", custom=True)
    assert cfg["kernels"][0].shape[0] == (9 if "-W" in flags else 17)


def _double_clicks(points):
    """A ``plt.show`` that double-clicks each (x, y) of ``points`` on the
    current figure, through its canvas callbacks."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from matplotlib import pyplot as plt
    from matplotlib.backend_bases import MouseEvent

    def show(*args, **kwargs):
        fig = plt.gcf()
        for x, y in points:
            px, py = fig.axes[0].transData.transform((x + 0.3, y + 0.2))
            for _ in range(2):
                event = MouseEvent("button_press_event", fig.canvas, px, py, button=1)
                fig.canvas.callbacks.process("button_press_event", event)
        plt.close("all")

    return plt, show


@pytest.mark.parametrize("chroms", [None, "chr1"])
def test_generate_config_click_matches_jax(tmp_path, monkeypatch, chroms):
    """``generate-config --click``: with ``plt.show`` stubbed to feed two
    double-clicks (Agg backend), the captured kernel equals the JAX
    package's under the same stub, within the float32 preprocessing's
    rounding."""
    pytest.importorskip("matplotlib")
    plt, show = _double_clicks([(60, 40), (100, 75)])
    monkeypatch.setattr(plt, "show", show)
    flags = ["--click", str(EXAMPLE_COOL)] + ([] if chroms is None else ["--chroms", chroms])
    monkeypatch.chdir(tmp_path)
    assert quiet(tcli.main, ["generate-config", *flags, "t"], device="cpu") == 0
    assert quiet(jcli.main, ["generate-config", *flags, "j"]) == 0
    ours, ref = np.loadtxt(tmp_path / "t.1.txt"), np.loadtxt(tmp_path / "j.1.txt")
    assert ours.shape == ref.shape == (17, 17)
    assert np.all(np.isfinite(ref)) and np.abs(ref).max() > 0
    assert np.allclose(ours, ref, rtol=1e-5, atol=1e-7)


LIST_ARGVS = [
    ["list-kernels"],
    ["list-kernels", "--long"],
    ["list-kernels", "--mat"],
    ["list-kernels", "--long", "--mat"],
    ["list-kernels", "--name", "loops", "--long", "--mat"],
]


@pytest.mark.parametrize("argv", LIST_ARGVS, ids=[" ".join(a[1:]) or "all" for a in LIST_ARGVS])
def test_list_kernels_byte_identical(argv, monkeypatch):
    """``list-kernels`` prints what the JAX package prints, the terminal
    width fixed (``print_ascii_mat`` reads it)."""
    monkeypatch.setattr(os, "get_terminal_size", lambda *a: os.terminal_size((100, 40)))
    out = {}
    for tag, run in (("t", tcli.main), ("j", jcli.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run(argv) == 0
        out[tag] = buf.getvalue()
    assert out["t"] == out["j"] and out["t"].startswith("borders\n" if len(argv) < 4 else "loops")
    if argv == ["list-kernels"]:
        assert out["t"].split() == sorted(p.stem for p in (ROOT / "chromosight_tpu" / "kernels"
                                                           / "data").glob("*.json"))
    with pytest.raises(ValueError, match="not available"):
        tcli.main(["list-kernels", "--name", "nope"])


def test_self_test_log_matches_golden(tmp_path, monkeypatch):
    """``test`` with the download failing falls back to the repository's
    example map: 89 patterns, the log's line set equals ``TEST_LOG``, and
    no "test log differed" warning."""

    def offline(url, path):
        raise OSError("no network in this test")

    monkeypatch.setattr(tcli, "download_file", offline)
    monkeypatch.chdir(tmp_path)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["test"], device="cpu") == 0
    log = err.getvalue()
    lines = {u.strip("\x1b[K") for u in set(log.split("\n")) if "\r" not in u}
    assert lines == set(tcli.TEST_LOG.split("\n"))
    assert "test log differed" not in log
    assert len(pd.read_csv(tmp_path / "chromosight_test.tsv", sep="\t")) == 89
    assert tcli.example_dataset() == str(EXAMPLE_COOL)


def test_version_prints_logo(monkeypatch):
    """``--version``: the JAX package's logo art and version line, with
    the port's name."""
    monkeypatch.setattr(os, "get_terminal_size", lambda *a: os.terminal_size((100, 40)))
    out = {}
    for tag, run in (("t", tcli.main), ("j", jcli.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run(["--version"]) == 0
        out[tag] = buf.getvalue()
    assert out["t"] == out["j"].replace("chromosight-tpu", "chromosight-torch")
    assert out["t"].count("\n") > 5
