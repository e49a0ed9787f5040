"""The port's public API name for name against the JAX package's.

Every public name of ``chromosight_tpu.{detection, preprocessing, io,
stats, plotting, runtime, runtime.contact_map, cli.main}`` (its
``__all__``, else the functions, classes and constants of the package
it holds) is in the same module of ``chromosight_torch``: a function or
method takes the JAX package's parameters first, in order, with the
same kinds and defaults (a parameter without a default there may have
one here; any parameter the port adds has one), a property stays a
property or an attribute of every instance, and a constant holds the
same value.  The names that exist
only for XLA's compile-per-shape or the TPU's compile cache
(``TPU_ONLY``) stay out, each with its reason.

Then the behaviour of the names the port gained, on
data_test/example.cool with ``device="cpu"``: ``normalize(threads=...)``
stores the JAX package's weights bit for bit, ``DumpMatrix`` writes the
npz the JAX package's decorator writes, ``preprocess_intra_matrix()``
leaves a fetched map as ``create_mat`` does, the ``band``, ``dense``,
``band_dev`` and ``matrix`` views hold the JAX package's values,
``pixels_upper`` and ``band_upper_counts`` are exact,
``write_patterns(coords=..., output_prefix=...)`` writes the JAX
package's bytes, and ``cmd_detect`` / ``cmd_quantify`` write ``main``'s
files byte for byte.
"""

import contextlib
import importlib
import inspect
import io
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import chromosight_torch.cli.main as tcli
import chromosight_torch.kernels as tk
import chromosight_tpu.cli.main as jcli
import chromosight_tpu.kernels as jk
from chromosight_torch.cli.args import parse_args
from chromosight_torch.io.source import CoolSource
from chromosight_torch.runtime import DumpMatrix, HicGenome
from chromosight_tpu.io.cool import CoolFile as JaxCoolFile
from chromosight_tpu.runtime import DumpMatrix as JaxDumpMatrix
from chromosight_tpu.runtime import HicGenome as JaxHicGenome
from torch_parity import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
EXAMPLE_COOL = str(ROOT / "data_test" / "example.cool")
EXAMPLE_BED2 = str(ROOT / "data_test" / "example.bed2")

MODULES = ["detection", "preprocessing", "io", "stats", "plotting", "runtime",
           "runtime.contact_map", "cli.main"]
# the JAX package's names that the port leaves out, and why
TPU_ONLY = {
    "pow2": "pads sizes to powers of two so that XLA compiles one program per bucket",
    "bucket_size": "rounds band shapes up to XLA's shape buckets",
    "ROW_BUCKET": "the smallest row bucket of XLA's band programs",
    "COL_BUCKET": "the smallest column bucket of XLA's band programs",
    "warm_band_programs": "compiles each bucket's XLA programs ahead of the scan",
    "jax_default_backend_is_cpu": "asks JAX which backend it compiles for",
    "init_compilation_cache": "opens the TPU's persistent XLA compile cache",
    "init_platform": "picks JAX's platform before the compile cache opens",
}
EMPTY = inspect.Parameter.empty
VARIADIC = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kwargs)


def _public(module):
    """The public names of a JAX module: its ``__all__``, else its
    functions and classes from the JAX package and its constants."""
    names = getattr(module, "__all__", None)
    if names is not None:
        return list(names)
    out = []
    for name, obj in vars(module).items():
        if name.startswith("_") or inspect.ismodule(obj) or type(obj).__name__ == "_Feature":
            continue
        if (inspect.isfunction(obj) or inspect.isclass(obj)) and not obj.__module__.startswith(
            "chromosight_tpu"
        ):
            continue  # imported from elsewhere (functools.partial, contextmanager)
        out.append(name)
    return out


NAMES = [(m, n) for m in MODULES for n in _public(importlib.import_module(f"chromosight_tpu.{m}"))]


def _unwrapped(fn):
    """The method under the JAX package's ``DumpMatrix`` (which keeps no
    signature)."""
    if getattr(fn, "__name__", "") == "decorated_fn" and fn.__closure__:
        return next(c.cell_contents for c in fn.__closure__ if inspect.isfunction(c.cell_contents))
    return fn


def assert_compatible(ref, got, where):
    """``got`` takes ``ref``'s parameters first, in order, with the same
    kinds and defaults; its own further parameters have defaults."""
    ref_params = list(inspect.signature(_unwrapped(ref)).parameters.values())
    got_params = list(inspect.signature(_unwrapped(got)).parameters.values())
    assert len(got_params) >= len(ref_params), where
    for a, b in zip(ref_params, got_params):
        assert (a.name, a.kind) == (b.name, b.kind), (where, a, b)
        if a.default is not EMPTY:
            assert b.default is not EMPTY and b.default == a.default, (where, a, b)
    for b in got_params[len(ref_params):]:
        assert b.default is not EMPTY or b.kind in VARIADIC, (where, b)


def assert_same_value(ref, got, where):
    if isinstance(ref, np.ndarray):
        assert np.array_equal(ref, got), where
    else:
        assert ref == got, where


# a port instance of the classes whose data the port keeps in plain
# attributes where the JAX package has properties
INSTANCES = {"ContactMap": lambda cls: cls(None, [(0, 4), (0, 4)], device="cpu")}


def assert_member(jcls, tcls, name, where):
    """A JAX method's counterpart is compatible; a JAX property's is a
    property, or an attribute every instance has."""
    ref = inspect.getattr_static(jcls, name)
    if isinstance(ref, property):
        if not isinstance(getattr(tcls, name, None), property):
            assert hasattr(INSTANCES[tcls.__name__](tcls), name), where
    else:
        assert hasattr(tcls, name), f"chromosight_torch.{where} is missing"
        if isinstance(ref, (staticmethod, classmethod)) or inspect.isfunction(ref):
            assert_compatible(getattr(jcls, name), getattr(tcls, name), where)


@pytest.mark.parametrize("module,name", NAMES, ids=[f"{m}.{n}" for m, n in NAMES])
def test_public_name_in_port(module, name):
    """The JAX package's public name in the port's module, compatible."""
    ref = getattr(importlib.import_module(f"chromosight_tpu.{module}"), name)
    port = importlib.import_module(f"chromosight_torch.{module}")
    where = f"{module}.{name}"
    if name in TPU_ONLY:
        assert not hasattr(port, name), where
        return
    assert hasattr(port, name), f"chromosight_torch.{where} is missing"
    got = getattr(port, name)
    if inspect.isclass(ref):
        assert inspect.isclass(got), where
        assert_compatible(ref.__init__, got.__init__, f"{where}.__init__")
        members = [n for n in vars(ref) if not n.startswith("_") or n == "__call__"]
        for member in members:
            assert_member(ref, got, member, f"{where}.{member}")
    elif callable(ref):
        assert_compatible(ref, got, where)
    else:
        assert_same_value(ref, got, where)


def test_tpu_only_names_are_the_jax_packages():
    """Each left-out name is one of the JAX package's, and the port has
    no module of the compile cache."""
    found = {n for m in MODULES for n in dir(importlib.import_module(f"chromosight_tpu.{m}"))}
    found |= set(dir(importlib.import_module("chromosight_tpu.config")))
    assert set(TPU_ONLY) <= found
    assert importlib.util.find_spec("chromosight_torch.config") is None


# ------------------------------------------------------------------ #
# behaviour on the example map
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("threads", [1, 4])
def test_normalize_threads_weights_bit_for_bit(tmp_path, monkeypatch, threads):
    """``normalize("force", threads=...)`` on copies of the example: the
    port stores the JAX package's weights bit for bit, whatever the
    count (both accept it and ignore it; their chromosome blocks go to
    a pool of 3 here)."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_ICE_BLOCK_THREADS", "3")
    ours, ref = tmp_path / "ours.cool", tmp_path / "ref.cool"
    shutil.copy(EXAMPLE_COOL, ours)
    shutil.copy(EXAMPLE_COOL, ref)
    genome = HicGenome(str(ours), kernel_config=dict(tk.loops), device="cpu")
    quiet(genome.normalize, "force", 5, threads=threads)
    jgenome = JaxHicGenome(str(ref), kernel_config=dict(jk.loops))
    quiet(jgenome.normalize, norm="force", n_mads=5, threads=threads)
    got = CoolSource(str(ours)).weights
    want = JaxCoolFile(str(ref)).weights
    assert np.isfinite(got).sum() == 637
    assert got.tobytes() == want.tobytes()
    assert genome.bins["weight"].to_numpy().tobytes() == want.tobytes()
    assert np.array_equal(genome.detectable_bins, jgenome.detectable_bins)


def _maps(norm="auto", port_kw=None):
    """The example's band maps of both packages, not created:
    [(jax map, port map)]."""
    jgenome = JaxHicGenome(EXAMPLE_COOL, kernel_config=dict(jk.loops))
    genome = HicGenome(EXAMPLE_COOL, kernel_config=dict(tk.loops), device="cpu",
                       **(port_kw or {}))
    for g in (jgenome, genome):
        quiet(g.normalize, norm)
        g.compute_max_dist()
        quiet(g.make_sub_matrices)
    return list(zip(jgenome.sub_mats.contact_map, genome.sub_mats.contact_map))


def _npz(path):
    mat = sp.load_npz(path)
    return mat.format, mat.dtype, mat.toarray()


@pytest.mark.parametrize("named", [True, False])
def test_dump_matrix_writes_the_jax_packages_npz(tmp_path, named):
    """A method of the port's map decorated by the port's ``DumpMatrix``
    and by the JAX package's: the same npz (format, dtype, values) and
    the same line, under ``<name>_<stage>`` or, for a map without a name,
    ``<stage>``; a map without a dump directory writes nothing."""
    _, cm = _maps()[0]
    quiet(cm.create_mat)
    if not named:
        cm.name = ""

    def settle(inst):
        return inst.shape

    lines = {}
    for which, decorator in (("port", DumpMatrix), ("jax", JaxDumpMatrix)):
        cm.dump = tmp_path / which
        cm.dump.mkdir()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert decorator("07_settled")(settle)(cm) == cm.shape
        lines[which] = out.getvalue().replace(str(tmp_path / which), "DIR")
    stem = f"{cm.name}_07_settled" if named else "07_settled"
    assert lines["port"] == lines["jax"] == f"Dumping matrix to DIR/{stem} after executing settle\n"
    port, ref = _npz(tmp_path / "port" / f"{stem}.npz"), _npz(tmp_path / "jax" / f"{stem}.npz")
    assert port[:2] == ref[:2] == ("csr", np.float64)
    assert np.array_equal(port[2], ref[2]) and np.count_nonzero(port[2]) > 1000
    cm.dump = None
    with contextlib.redirect_stdout(io.StringIO()) as out:
        DumpMatrix("07_settled")(settle)(cm)
    assert out.getvalue() == ""


@pytest.mark.parametrize("norm", ["auto", "raw"])
def test_preprocess_intra_matrix_equals_create_mat(norm):
    """Each example chromosome fetched whole through ``subsample(1.0)``
    (balanced unless ``--norm raw``) and preprocessed by
    ``preprocess_intra_matrix()`` is ``create_mat``'s band bit for bit.
    On a balanced map ``detrend()`` then ``remove_diags()`` (the staged
    path of ``--dump``) agree with it within the float32 ulps of their
    distance laws once NaN pixels are zeroed."""
    for _, cm in _maps(norm):
        quiet(cm.create_mat)
        want = cm.band_dev.clone()
        cm.destroy_mat()
        cm.subsample(1.0, balance=norm != "raw")
        assert cm.band_dev.shape == want.shape
        cm.preprocess_intra_matrix()
        assert torch.equal(cm.band_dev, want), cm.name
        if norm == "auto":
            cm.subsample(1.0)
            cm.detrend()
            cm.remove_diags()
            staged = torch.nan_to_num(cm.band_dev, nan=0.0)
            assert torch.allclose(staged, want, rtol=1e-6, atol=1e-7), cm.name


def test_views_hold_the_jax_packages_values():
    """After ``create_mat``: ``band`` is a host float64 (n, W) array, the
    JAX package's band on the port's W columns within 1e-6 (the JAX
    band holds only zeros past them), ``band_dev`` its float32 tensor,
    ``dense`` the band's upper triangle and the JAX package's ``dense``,
    ``matrix`` the JAX package's CSR view; the raw counts of
    ``subsample(1.0, balance=False)`` are the JAX package's exactly."""
    for jcm, cm in _maps():
        quiet(jcm.create_mat)
        quiet(cm.create_mat)
        n = cm.shape[0]
        band = cm.band
        assert isinstance(band, np.ndarray) and band.dtype == np.float64
        assert band.shape == (n, cm.keep_distance + 1)
        assert isinstance(cm.band_dev, torch.Tensor) and cm.band_dev.dtype == torch.float32
        assert np.array_equal(band, cm.band_dev.numpy().astype(np.float64))
        ref = jcm.band
        width = band.shape[1]
        assert not ref[:, width:].any()
        assert np.array_equal(ref[:, :width] == 0, band == 0)
        assert np.allclose(band, ref[:, :width], rtol=1e-6, atol=1e-7)
        dense = cm.dense
        assert isinstance(dense, np.ndarray) and dense.shape == (n, n)
        assert np.array_equal(np.triu(dense), dense)
        assert np.allclose(dense, jcm.dense, rtol=1e-6, atol=1e-7)
        i, d = np.nonzero(band)
        ok = i + d < n
        assert np.array_equal(dense[i[ok], i[ok] + d[ok]], band[i[ok], d[ok]])
        mat = cm.matrix
        assert sp.isspmatrix_csr(mat) and np.array_equal(mat.toarray(), dense)
        assert cm.sparse is None and cm.dense_dev is None
        jcm.subsample(1.0, balance=False)
        cm.subsample(1.0, balance=False)
        assert np.array_equal(cm.band, jcm.band[:, :width])
        assert not jcm.band[:, width:].any() and cm.band.sum() > 1000
        cm.destroy_mat()
        assert cm.band is None and cm.dense is None and cm.matrix is None


def test_matrix_setter_makes_a_dense_map():
    """``matrix = M`` (dense or sparse) makes the map dense on its device,
    as the JAX package's setter does; ``None`` empties it."""
    _, cm = _maps()[0]
    quiet(cm.create_mat)
    mat = np.random.RandomState(0).rand(12, 12)
    for value in (mat, sp.csr_matrix(mat)):
        cm.matrix = value
        assert cm.band_dev is None and cm.band is None
        assert cm.dense_dev.dtype == torch.float64 and np.array_equal(cm.dense, mat)
    cm.matrix = None
    assert cm.dense is None and cm.matrix is None


@pytest.mark.parametrize("balance", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_diag", [None, 40])
def test_pixels_upper_exact(balance, dtype, max_diag):
    """``pixels_upper`` of each chromosome: the JAX package's rows, cols
    and values exactly, in the same dtypes."""
    ours, ref = CoolSource(EXAMPLE_COOL), JaxCoolFile(EXAMPLE_COOL)
    for chrom in ours.chromnames:
        ext = ours.extent(chrom)
        got = ours.pixels_upper(ext, balance=balance, dtype=dtype, max_diag=max_diag)
        want = ref.pixels_upper(ext, balance=balance, dtype=dtype, max_diag=max_diag)
        assert len(got[0]) > 1000
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    empty = ours.pixels_upper((5, 5))
    assert [len(a) for a in empty] == [0, 0, 0] and empty[2].dtype == np.float32


@pytest.mark.parametrize("width,n_rows", [(100, None), (251, 300)])
def test_band_upper_counts_exact(width, n_rows):
    """``band_upper_counts``: the JAX package's uint16 band exactly, and
    None where it gives None (counts that are not integers)."""
    ours, ref = CoolSource(EXAMPLE_COOL), JaxCoolFile(EXAMPLE_COOL)
    for chrom in ours.chromnames:
        ext = ours.extent(chrom)
        got = ours.band_upper_counts(ext, width, n_rows=n_rows)
        want = ref.band_upper_counts(ext, width, n_rows=n_rows)
        assert got.dtype == want.dtype == np.uint16 and np.array_equal(got, want)
        assert got.shape == (n_rows or ext[1] - ext[0], width) and got.sum() > 1000
    ours._columns = ours._columns[:2] + (np.zeros(ours.nnz, np.float32) + 0.5,)
    assert ours.band_upper_counts(ours.extent("chr1"), width) is None


def test_write_patterns_keywords(tmp_path):
    """``write_patterns(coords=..., output_prefix=..., dec=...)`` with a
    DataFrame writes the bytes of the JAX package's ``write_patterns``."""
    import chromosight_torch.io as tio
    import chromosight_tpu.io as jio

    table = pd.read_csv(ROOT / "tests" / "data" / "golden_detect_loops.tsv", sep="\t")
    for dec in (10, 3):
        tio.write_patterns(coords=table, output_prefix=str(tmp_path / f"t{dec}"), dec=dec)
        jio.write_patterns(coords=table, output_prefix=str(tmp_path / f"j{dec}"), dec=dec)
        got = (tmp_path / f"t{dec}.tsv").read_bytes()
        assert got == (tmp_path / f"j{dec}.tsv").read_bytes() and got.count(b"\n") == 90


@pytest.mark.parametrize("command", ["detect", "quantify"])
def test_cmd_detect_and_quantify_write_mains_files(tmp_path, command):
    """``cmd_detect(args, device)`` / ``cmd_quantify(args, device)`` open
    the map named in ``args`` and write ``main``'s files byte for byte."""
    head = ["detect"] if command == "detect" else ["quantify"]
    tail = [EXAMPLE_COOL] if command == "detect" else [EXAMPLE_BED2, EXAMPLE_COOL]
    argv = [*head, "--no-plotting", *tail]
    quiet(tcli.main, [*argv, str(tmp_path / "main")], device="cpu")
    args = parse_args([*argv, str(tmp_path / "cmd")], tcli.__doc__)
    run = tcli.cmd_detect if command == "detect" else tcli.cmd_quantify
    quiet(run, args, device="cpu")
    for ext in ("tsv", "json"):
        want = (tmp_path / f"main.{ext}").read_bytes()
        assert (tmp_path / f"cmd.{ext}").read_bytes() == want and len(want) > 1000


def test_logo_and_local_example_dataset():
    """``LOGO`` is the JAX package's, ``logo_version(LOGO, ver)`` its text
    under the port's name, and ``LOCAL_EXAMPLE_DATASET`` the repository's
    example unless ``CHROMOSIGHT_TPU_TEST_COOL`` names another file (the
    self-test's fallback follows it)."""
    assert np.array_equal(tcli.LOGO, jcli.LOGO)
    ours = tcli.logo_version(tcli.LOGO, "9.9")
    assert ours == jcli.logo_version(jcli.LOGO, "9.9").replace("chromosight-tpu",
                                                               "chromosight-torch")
    assert tcli.LOCAL_EXAMPLE_DATASET == jcli.LOCAL_EXAMPLE_DATASET == tcli.example_dataset()
    env = dict(os.environ, CHROMOSIGHT_TPU_TEST_COOL="/elsewhere/x.cool",
               PYTHONPATH=str(ROOT))
    code = ("import chromosight_torch.cli.main as m; "
            "print(m.LOCAL_EXAMPLE_DATASET, m.example_dataset())")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.split() == ["/elsewhere/x.cool", "/elsewhere/x.cool"]
