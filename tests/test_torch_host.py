"""The port's own copies of the JAX package's host helpers against their
originals, on the same seeded numpy inputs: preprocessing, FDR, the CLI
grammar, the native library (every definition of its source the
original's text; connected components, neighbour suppression, the fused
band scatter, ICE marginals), ICE weights bit for bit, the stage timers,
the preset files, and the CLI surface's copies (``print_ascii_mat``,
``subsample_contacts``, ``_extract_window``, ``TEST_LOG``, the logo)."""

import contextlib
import io
import os
import pathlib
import re

import numpy as np
import pytest

import chromosight_torch.native as t_native
import chromosight_torch.observability as t_obs
import chromosight_torch.preprocessing as t_pre
import chromosight_tpu.native as j_native
import chromosight_tpu.preprocessing as j_pre
from chromosight_torch.cli.args import CliError as TCliError
from chromosight_torch.cli.args import parse_args as t_parse_args
from chromosight_torch.io.config import load_kernel_config
from chromosight_torch.io.source import ArraySource
from chromosight_torch.ops.balance import ice_balance as t_ice_balance
from chromosight_torch.stats import fdr_correction as t_fdr
from chromosight_tpu.cli.args import CliError as JCliError
from chromosight_tpu.cli.args import parse_args as j_parse_args
from chromosight_tpu.ops.balance import ice_balance as j_ice_balance
from chromosight_tpu.stats import fdr_correction as j_fdr
from torch_parity import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
EXAMPLE_NPZ = ROOT / "tests" / "data" / "example_cool.npz"
PRESET_NAMES = sorted(p.stem for p in (ROOT / "chromosight_tpu" / "kernels" / "data").glob("*.json"))
PORT_CPP = ROOT / "chromosight_torch" / "native" / "kernels.cpp"
JAX_CPP = ROOT / "chromosight_tpu" / "native" / "kernels.cpp"


def cpp_definitions(path):
    """{name: source text} of the top-level function definitions (from
    the signature to the first line that starts with a closing brace)
    and ``#define`` ... ``#undef`` macro blocks of a C++ file."""
    text = path.read_text()
    out = {}
    for m in re.finditer(
        r"^(?:template <[^>]*>\n)?(?:static )?(?:inline )?[\w:]+ \*?(\w+)\(.*?^\}",
        text, re.S | re.M,
    ):
        out.setdefault(m.group(1), m.group(0))
    for m in re.finditer(r"^#define (\w+).*?^#undef \1$", text, re.S | re.M):
        out[m.group(1)] = m.group(0)
    return out


NATIVE_DEFINITIONS = sorted(cpp_definitions(PORT_CPP))


def test_native_libraries_build():
    assert t_native.get_lib() is not None and j_native.get_lib() is not None
    built = pathlib.Path(t_native.get_lib()._name)
    assert built.is_relative_to(t_native.BUILD_DIR)
    assert not list(pathlib.Path(t_native.__file__).parent.glob("*.so"))


@pytest.mark.parametrize("name", NATIVE_DEFINITIONS)
def test_native_source_is_a_copy(name):
    """Every definition of the port's kernels.cpp is its original's text."""
    assert cpp_definitions(PORT_CPP)[name] == cpp_definitions(JAX_CPP)[name]


def test_native_count_path_copied():
    """The count scatters, their ``_b2i32`` macro block, the trans fetch
    and ``coo_to_band`` are among the copies, and the port's library
    exports every entry its wrappers bind."""
    assert {
        "coo_to_band_f32", "coo_to_band_f64", "band_scatter_counts_indptr_impl",
        "band_scatter_counts_u8_indptr_impl", "band_scatter_counts_u4_indptr_impl",
        "CHROMO_EXPORT_B2I32", "trans_range_offsets_impl", "trans_fill_balance_impl",
        "CHROMO_EXPORT_TRANS_FILL",
    } <= set(NATIVE_DEFINITIONS)
    lib = t_native.get_lib()
    for b2 in ("", "_b2i32"):
        getattr(lib, f"trans_range_offsets{b2}")
        for ct in ("i32", "i64", "f64"):
            for kind in ("indptr", "u8_indptr", "u4_indptr"):
                getattr(lib, f"band_scatter_counts_{kind}_{ct}{b2}")
        for ct in ("i32", "i64", "f32", "f64"):
            getattr(lib, f"trans_fill_{ct}{b2}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_missing_flags(seed):
    rng = np.random.RandomState(seed)
    size = 200
    valid = rng.randint(-10, size + 10, size=rng.randint(0, 150))
    out = t_pre.missing_flags(valid, size)
    assert out.dtype == bool
    assert np.array_equal(out, j_pre.missing_flags(valid, size))
    assert np.array_equal(t_pre.missing_flags([], 7), j_pre.missing_flags([], 7))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pava_decreasing(seed):
    rng = np.random.RandomState(seed)
    y = np.concatenate([np.sort(rng.rand(60))[::-1] + 0.2 * rng.randn(60), np.zeros(20)])
    out = t_pre.pava_decreasing(y)
    assert np.array_equal(out, j_pre.pava_decreasing(y))
    assert np.all(np.diff(out) <= 0)


@pytest.mark.parametrize("name", PRESET_NAMES)
@pytest.mark.parametrize("prop_info", [0.9, 0.999])
def test_factorise_kernel(name, prop_info):
    kernel = load_kernel_config(name)["kernels"][0]
    err_t, err_j = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err_t):
        lt, rt = t_pre.factorise_kernel(kernel, prop_info)
    with contextlib.redirect_stderr(err_j):
        lj, rj = j_pre.factorise_kernel(kernel, prop_info)
    assert np.array_equal(lt, lj) and np.array_equal(rt, rj)
    assert err_t.getvalue() == err_j.getvalue()


@pytest.mark.parametrize("name", ["loops", "borders", "hairpins"])
@pytest.mark.parametrize("factor", [0.5, 1.3, 2.0])
def test_resize_kernel(name, factor):
    kernel = load_kernel_config(name)["kernels"][0]
    err_t, err_j = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err_t):
        out = t_pre.resize_kernel(kernel, factor=factor)
    with contextlib.redirect_stderr(err_j):
        ref = j_pre.resize_kernel(kernel, factor=factor)
    assert out.shape == ref.shape and out.shape[0] % 2 == 1
    assert np.array_equal(out, ref)
    assert err_t.getvalue() == err_j.getvalue()


def test_resize_kernel_refusals():
    for kwargs in ({}, {"factor": 2, "kernel_res": 1}):
        with pytest.raises(ValueError):
            t_pre.resize_kernel(np.ones((5, 5)), **kwargs)
    with pytest.raises(ValueError):
        t_pre.resize_kernel(np.ones((4, 4)), factor=2)


@pytest.mark.parametrize("seed", [0, 1])
def test_fdr_correction(seed):
    rng = np.random.RandomState(seed)
    pvals = rng.rand(300) ** 3
    pvals[::17] = pvals[3]  # ties
    assert np.array_equal(t_fdr(pvals), j_fdr(pvals))
    assert t_fdr(None) is None


ARGVS = [
    ["detect", "in.cool", "out"],
    ["detect", "-P", "borders", "--pearson=0.4", "-W", "9", "--tsvd", "in.cool", "out"],
    ["detect", "--no-plotting", "--dump", "d", "--smooth-trend", "--norm", "raw", "a", "b"],
    ["quantify", "--pattern", "loops", "-V", "x.bed2", "in.cool", "out"],
    ["generate-config", "--preset", "borders", "p"],
    ["list-kernels", "--long", "--mat"],
    ["detect", "--max-dist"],
    ["detect", "--bogus", "a", "b"],
    ["detect", "only_one"],
    ["nonsense"],
    ["--version"],
    [],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "empty" for a in ARGVS])
def test_parse_args(argv):
    def run(parse, error):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                res = parse(argv, "USAGE", version="v")
            except error as exc:
                res = ("exit", exc.code)
        return res, out.getvalue(), err.getvalue()

    assert run(t_parse_args, TCliError) == run(j_parse_args, JCliError)
    assert issubclass(TCliError, SystemExit)


def _pixels(rng, n_rows=60, n_cols=80, density=0.15):
    flat = np.flatnonzero(rng.rand(n_rows * n_cols) < density)
    return flat // n_cols, flat % n_cols, n_cols


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cc_label(seed):
    rows, cols, n_cols = _pixels(np.random.RandomState(seed))
    out = t_native.cc_label(rows, cols, n_cols)
    assert out is not None
    assert np.array_equal(out, j_native.cc_label(rows, cols, n_cols))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("win_size", [0, 3, 8])
def test_remove_neighbours(seed, win_size):
    rng = np.random.RandomState(seed)
    n = 400
    b1 = rng.randint(0, 500, n)
    b2 = b1 + rng.randint(0, 60, n)
    score = rng.rand(n).round(2)  # ties
    score[::23] = np.nan
    out = t_native.remove_neighbours(b1, b2, score, win_size)
    assert out is not None and out.dtype == bool
    assert np.array_equal(out, j_native.remove_neighbours(b1, b2, score, win_size))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64, np.float32])
@pytest.mark.parametrize("balanced", [False, True])
def test_band_scatter_fused(dtype, balanced):
    rng = np.random.RandomState(5)
    s, e, n_bins, width = 40, 200, 260, 30
    b1 = np.sort(rng.randint(s - 5, e + 5, 3000))
    b2 = b1 + rng.randint(-2, 45, b1.size)
    counts = rng.poisson(4, b1.size).astype(dtype)
    weights = None
    if balanced:
        weights = rng.rand(n_bins) + 0.5
        weights[[50, 77]] = np.nan
    args = (b1, b2, counts, weights, s, e, width)
    out = t_native.band_scatter_fused(*args, n_rows=e - s + 8)
    ref = j_native.band_scatter_fused(*args, n_rows=e - s + 8)
    assert out.dtype == np.float32 and out.shape == (e - s + 8, width)
    assert np.array_equal(out, ref, equal_nan=True)


@pytest.mark.parametrize("compact", [False, True])
def test_marginal_sums(compact):
    rng = np.random.RandomState(3)
    n_bins = 300
    b1 = rng.randint(0, n_bins, 5000)
    b2 = np.minimum(b1 + rng.randint(0, 40, b1.size), n_bins - 1)
    counts = rng.poisson(3, b1.size).astype(np.float64)
    if compact:
        b1, b2, counts = b1.astype(np.int32), b2.astype(np.int32), counts.astype(np.float32)
    bias = rng.rand(n_bins) + 0.5
    out = t_native.marginal_sums(b1, b2, counts, bias, n_bins)
    assert np.array_equal(out, j_native.marginal_sums(b1, b2, counts, bias, n_bins))


@pytest.mark.parametrize("cis_only", [True, False])
@pytest.mark.parametrize("whole_loop", ["1", "0"])
def test_ice_weights_bit_for_bit(cis_only, whole_loop, monkeypatch):
    """``ice_balance`` of the example map: the port's weights equal the
    JAX package's bit for bit, through the whole-loop native path and
    the streaming path, under the module's one-thread count."""
    monkeypatch.setenv("CHROMOSIGHT_TPU_ICE_NATIVE", whole_loop)
    src = ArraySource.from_npz(EXAMPLE_NPZ)
    ours = t_ice_balance(src, cis_only=cis_only, store=False)
    ref = j_ice_balance(src, cis_only=cis_only, store=False)
    assert np.isfinite(ours).sum() > 600
    assert np.array_equal(ours, ref, equal_nan=True)
    assert ours.tobytes() == ref.tobytes()


def test_stage_timers():
    t_obs.reset()
    with t_obs.stage("a"):
        pass
    with t_obs.stage("a"):
        pass
    totals, counts, nbytes = t_obs.snapshot()
    assert counts == {"a": 2} and totals["a"] >= 0 and nbytes == {}
    t_obs.reset()
    assert t_obs.snapshot() == ({}, {}, {})


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_presets_are_byte_identical_copies(name):
    ours = ROOT / "chromosight_torch" / "kernels" / "data" / f"{name}.json"
    ref = ROOT / "chromosight_tpu" / "kernels" / "data" / f"{name}.json"
    assert ours.read_bytes() == ref.read_bytes()
    assert load_kernel_config(name)["kernels"][0].ndim == 2


def _sparse_case(seed, shape=(70, 90), density=0.2):
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    mat = rng.rand(*shape) * (rng.rand(*shape) < density)
    return sp.csr_matrix(mat), rng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_valid_to_missing(seed):
    rng = np.random.RandomState(seed)
    valid = rng.randint(-10, 210, size=rng.randint(0, 150))
    out = t_pre.valid_to_missing(valid, 200)
    assert np.array_equal(out, j_pre.valid_to_missing(valid, 200))
    assert np.array_equal(t_pre.valid_to_missing([], 7), j_pre.valid_to_missing([], 7))


@pytest.mark.parametrize("n", [0, 3, 25])
def test_diag_trim(n):
    mat, _ = _sparse_case(3, (60, 60))
    out, ref = t_pre.diag_trim(mat, n), j_pre.diag_trim(mat, n)
    assert out.format == "csr" and np.array_equal(out.toarray(), ref.toarray())
    dense = mat.toarray()
    assert np.array_equal(t_pre.diag_trim(dense, n), j_pre.diag_trim(dense, n))
    with pytest.raises(ValueError, match="csr"):
        t_pre.diag_trim(mat.tocoo(), n)


@pytest.mark.parametrize("sym_upper", [False, True])
@pytest.mark.parametrize("max_dist", [None, 0, 9])
def test_make_missing_mask(sym_upper, max_dist):
    rng = np.random.RandomState(4)
    n = 80
    shape = (n, n) if sym_upper else (n, n + 15)
    valid_r = np.flatnonzero(rng.rand(shape[0]) > 0.1)
    valid_c = valid_r if sym_upper else np.flatnonzero(rng.rand(shape[1]) > 0.1)
    out = t_pre.make_missing_mask(shape, valid_r, valid_c, max_dist, sym_upper)
    ref = j_pre.make_missing_mask(shape, valid_r, valid_c, max_dist, sym_upper)
    assert out.dtype == ref.dtype == bool and out.format == "csr"
    assert np.array_equal(out.toarray(), ref.toarray())
    with pytest.raises(ValueError, match="upper symmetric"):
        t_pre.make_missing_mask((5, 6), np.arange(5), np.arange(6), None, True)


@pytest.mark.parametrize("kshape", [(7, 7), (5, 9), (17, 17)])
@pytest.mark.parametrize("sym_upper,max_dist", [(False, None), (True, None), (True, 12)])
def test_frame_missing_mask(kshape, sym_upper, max_dist):
    rng = np.random.RandomState(6)
    n = 70
    shape = (n, n) if sym_upper else (n, n + 11)
    valid_r = np.flatnonzero(rng.rand(shape[0]) > 0.1)
    valid_c = valid_r if sym_upper else np.flatnonzero(rng.rand(shape[1]) > 0.1)
    mask = j_pre.make_missing_mask(shape, valid_r, valid_c, max_dist, sym_upper)
    out = t_pre.frame_missing_mask(mask, kshape, sym_upper, max_dist)
    ref = j_pre.frame_missing_mask(mask, kshape, sym_upper, max_dist)
    assert out.dtype == bool and out.shape == ref.shape
    assert np.array_equal(out.toarray(), ref.toarray())
    with pytest.raises(ValueError, match="boolean"):
        t_pre.frame_missing_mask(mask.astype(np.float32), kshape)
    with pytest.raises(ValueError, match="sparse"):
        t_pre.frame_missing_mask(mask.toarray(), kshape)


@pytest.mark.parametrize("sparse", [False, True])
def test_check_missing_mask(sparse):
    mat, rng = _sparse_case(5)
    mask = j_pre.make_missing_mask(mat.shape, np.arange(60), np.arange(80))
    signal = mat if sparse else mat.toarray()
    mask_in = mask if sparse else mask.toarray()
    for fn in (t_pre.check_missing_mask, j_pre.check_missing_mask):
        with pytest.raises(ValueError, match="reported as missing") as exc:
            fn(signal, mask_in)
        if fn is t_pre.check_missing_mask:
            msg = str(exc.value)
        else:
            assert str(exc.value) == msg
    clean = mat.toarray()
    clean[mask.toarray()] = 0
    clean = type(mat)(clean) if sparse else clean
    assert t_pre.check_missing_mask(clean, mask_in) is None


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_zero_pad_sparse(fmt):
    mat, _ = _sparse_case(7)
    out = t_pre.zero_pad_sparse(mat.astype(np.float32), 4, 3, fmt=fmt)
    ref = j_pre.zero_pad_sparse(mat.astype(np.float32), 4, 3, fmt=fmt)
    assert out.format == ref.format == fmt and out.dtype == ref.dtype == np.float32
    assert np.array_equal(out.toarray(), ref.toarray())


@pytest.mark.parametrize("colored", [False, True])
@pytest.mark.parametrize("width", [30, 200])
def test_print_ascii_mat(colored, width, monkeypatch):
    """The ASCII art of every preset kernel and of a random matrix, at a
    narrow and a wide terminal, printed and returned."""
    import chromosight_torch.plotting as t_plot
    import chromosight_tpu.plotting as j_plot

    monkeypatch.setattr(os, "get_terminal_size", lambda *a: os.terminal_size((width, 40)))
    mats = [load_kernel_config(name)["kernels"][0] for name in PRESET_NAMES]
    mats.append(np.random.RandomState(2).rand(13, 41))
    for mat in mats:
        for adjust in (True, False):
            kw = dict(adjust=adjust, colored=colored)
            art = t_plot.print_ascii_mat(mat, print_str=False, **kw)
            assert art == j_plot.print_ascii_mat(mat, print_str=False, **kw)
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert t_plot.print_ascii_mat(mat, **kw) is None
            assert out.getvalue() == art


@pytest.mark.parametrize("seed", [0, 1])
def test_subsample_contacts(seed):
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    mat = sp.random(40, 50, density=0.3, random_state=rng, format="coo")
    mat.data = np.ceil(mat.data * 9)
    out = t_pre.subsample_contacts(mat, 100, np.random.RandomState(seed))
    np.random.seed(seed)
    ref = j_pre.subsample_contacts(mat, 100)
    assert out.format == ref.format == "coo" and out.dtype == ref.dtype
    for a, b in ((out.row, ref.row), (out.col, ref.col), (out.data, ref.data)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("center", [(8, 8), (0, 5), (20, 3), (5, 29), (12, 20)])
def test_extract_window(center):
    import chromosight_torch.plotting as t_plot
    import chromosight_tpu.plotting as j_plot

    dense = np.random.RandomState(1).rand(30, 25)
    out = t_plot._extract_window(dense, *center, 4)
    ref = j_plot._extract_window(dense, *center, 4)
    assert (out is None) == (ref is None)
    assert out is None or np.array_equal(out, ref)


def test_self_test_log_logo_and_kernel_names():
    """The golden log of ``test``, the logo file and the preset names."""
    import chromosight_torch.cli.main as t_cli
    import chromosight_torch.kernels as t_kernels
    import chromosight_tpu.cli.main as j_cli
    import chromosight_tpu.kernels as j_kernels

    assert t_cli.TEST_LOG == j_cli.TEST_LOG
    assert t_cli.URL_EXAMPLE_DATASET == j_cli.URL_EXAMPLE_DATASET
    ours = ROOT / "chromosight_torch" / "cli" / "logo.txt"
    assert ours.read_bytes() == (ROOT / "chromosight_tpu" / "cli" / "logo.txt").read_bytes()
    assert t_kernels.kernel_names == j_kernels.kernel_names == PRESET_NAMES
