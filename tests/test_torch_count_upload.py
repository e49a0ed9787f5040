"""The port's count-packed band path against the JAX package's, on the CPU.

The native copies (the u16, u8 + exceptions and u8-head / u4-tail count
scatters driven by ``bin1_offset``, with int32 and int64 bin2 ids; the
trans rectangle fetch; ``coo_to_band``) equal their originals bit for
bit, exceptions compared as sets (the OpenMP loop emits them in no set
order).  ``band_upper_counts_auto`` picks the JAX package's mode and
arrays.  ``band_unpack`` gives raw counts bit for bit as the JAX
finalizers do, and ``band_weighted`` balances them bit for bit as the
host's ``band_scatter_fused`` does (within 1e-5 of the JAX float32
product).  ``create_mat`` gives the f32 path's preprocessed band bit for
bit in u4, u8 and u16 modes, and the 89-loop golden byte for byte.
Neither the count path, ``row_slice_raw`` nor the trans fetch reads
``pixels/bin1_id``."""

import contextlib
import io
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

import chromosight_torch.native as t_native
import chromosight_torch.observability as obs
import chromosight_torch.ops.band as t_band
import chromosight_torch.runtime.contact_map as t_cm
import chromosight_tpu.native as j_native
import chromosight_tpu.ops.band as j_band
from chromosight_torch.cli.main import main
from chromosight_torch.io import hdf5
from chromosight_torch.io.cool import create_cool
from chromosight_torch.io.source import ArraySource, CoolSource
from chromosight_torch.kernels import loops
from chromosight_torch.runtime.genome import HicGenome
from chromosight_tpu.io.cool import CoolFile as JCoolFile
from torch_parity import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
EXAMPLE_COOL = str(ROOT / "data_test" / "example.cool")
GOLDEN = ROOT / "tests" / "data" / "golden_detect_loops.tsv"
COUNT_DTYPES = [np.int32, np.int64, np.float32, np.float64]
B2_DTYPES = [np.int32, np.int64]


def set_mode(monkeypatch, mode):
    """Make every band map take ``mode`` ("u4", "u8", "u16"; None: the
    f32 path), and clear the upload records."""
    monkeypatch.setattr(t_cm, "COUNT_PACKING", mode)
    obs.reset()


def uploaded_modes():
    return {name: r["mode"] for name, r in obs.band_uploads().items()}


def row_slice(seed, n=70, width=24, s=5, head=8, head_max=300, tail_max=20):
    """A row-sorted pixel slice of rows [s, s + n) as a cool file stores
    it: ``indptr`` (absolute, from an offset of 1000), global bin2 ids
    (some past the band, some past e) and int64 counts (zeros included:
    stored pixels of count 0), larger on the first ``head`` diagonals;
    and the matching bin1 ids."""
    rng = np.random.RandomState(seed)
    e = s + n
    b1, b2 = [], []
    for i in range(s, e):
        cols = np.unique(rng.randint(i, min(i + width + 6, e + 8), rng.randint(0, 14)))
        b1.append(np.full(len(cols), i))
        b2.append(cols)
    b1, b2 = np.concatenate(b1), np.concatenate(b2)
    d = b2 - b1
    counts = np.where(d < head, rng.randint(0, head_max, len(d)), rng.randint(0, tail_max, len(d)))
    indptr = 1000 + np.concatenate([[0], np.cumsum(np.bincount(b1 - s, minlength=n))])
    return indptr, b1, b2, counts.astype(np.int64), (s, e, width)


def same_exceptions(a, b):
    """Two (idx, val) exception lists hold the same entries."""
    (ia, va), (ib, vb) = a, b
    oa, ob = np.argsort(ia, kind="stable"), np.argsort(ib, kind="stable")
    assert np.array_equal(ia[oa], ib[ob]) and np.array_equal(va[oa], vb[ob])
    assert va.dtype == vb.dtype == np.float32 and ia.dtype == ib.dtype == np.int64


def same_pack(a, b):
    """Two count packs (tuples of arrays, exceptions last in u4/u8 mode)
    are equal, exceptions as sets."""
    assert (a is None) == (b is None)
    if a is None:
        return
    assert type(a) is type(b) and len(a) == len(b)
    if isinstance(a[0], str):
        assert a[0] == b[0]
        a, b = a[1:], b[1:]
    exc = len(a) > 1
    for x, y in zip(a[: len(a) - 2 * exc], b[: len(b) - 2 * exc]):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
    if exc:
        same_exceptions(a[-2:], b[-2:])


@pytest.mark.parametrize("b2_dtype", B2_DTYPES)
@pytest.mark.parametrize("dtype", COUNT_DTYPES)
def test_band_scatter_counts_indptr(dtype, b2_dtype):
    indptr, b1, b2, counts, (s, e, width) = row_slice(1, head_max=900)
    args = (indptr, b2.astype(b2_dtype), counts.astype(dtype), s, e, width)
    out = t_native.band_scatter_counts_indptr(*args, n_rows=e - s + 3)
    assert out is not None and out.shape == (e - s + 3, width)
    assert np.array_equal(out, j_native.band_scatter_counts_indptr(*args, n_rows=e - s + 3))
    # numpy's scatter of the same pixels gives the same band
    d = b2 - b1
    kept = (d < width) & (b2 < e)
    want = np.zeros((e - s + 3, width), np.uint16)
    want[b1[kept] - s, d[kept]] = counts[kept]
    assert np.array_equal(out, want) and want.max() > 255


@pytest.mark.parametrize("b2_dtype", B2_DTYPES)
@pytest.mark.parametrize("dtype", COUNT_DTYPES)
def test_band_scatter_counts_u8_indptr(dtype, b2_dtype):
    indptr, _, b2, counts, (s, e, width) = row_slice(2, head_max=400)
    args = (indptr, b2.astype(b2_dtype), counts.astype(dtype), s, e, width)
    out = t_native.band_scatter_counts_u8_indptr(*args, n_rows=e - s + 3)
    ref = j_native.band_scatter_counts_u8_indptr(*args, n_rows=e - s + 3)
    assert out[0].dtype == np.uint8 and out[0].shape == (e - s + 3, width)
    assert len(out[1]) > 0  # counts above 255 rode the exception list
    same_pack(out, ref)


@pytest.mark.parametrize("b2_dtype", B2_DTYPES)
@pytest.mark.parametrize("dtype", COUNT_DTYPES)
@pytest.mark.parametrize("d0", [1, 5, 12])
def test_band_scatter_counts_u4_indptr(d0, dtype, b2_dtype):
    indptr, _, b2, counts, (s, e, width) = row_slice(3, head=d0, head_max=400, tail_max=24)
    args = (indptr, b2.astype(b2_dtype), counts.astype(dtype), s, e, width, d0)
    out = t_native.band_scatter_counts_u4_indptr(*args, n_rows=e - s + 3)
    ref = j_native.band_scatter_counts_u4_indptr(*args, n_rows=e - s + 3)
    head, tail = out[:2]
    assert head.shape == (e - s + 3, d0) and tail.shape == (e - s + 3, (width - d0 + 1) // 2)
    assert len(out[2]) > 0  # head counts > 255 and tail counts > 15
    same_pack(out, ref)


@pytest.mark.parametrize(
    "variant,fault",
    [(v, f) for v in ("u16", "u8", "u4") for f in ("fraction", "negative", "above 2^24")]
    + [("u8", "exc_cap"), ("u4", "exc_cap")],
)
def test_count_scatter_refusals(variant, fault):
    """Non-integral, negative or too large counts, and more exceptions
    than the cap, give None from both libraries."""
    indptr, _, b2, counts, (s, e, width) = row_slice(4, head_max=400, tail_max=24)
    counts = counts.astype(np.float64)
    first_kept = np.flatnonzero((b2 - np.repeat(np.arange(s, e), np.diff(indptr)) < width)
                                & (b2 < e))[5]
    kwargs = {}
    if fault == "fraction":
        counts[first_kept] = 9.5
    elif fault == "negative":
        counts[first_kept] = -3
    elif fault == "above 2^24":
        counts[first_kept] = (1 << 24) + 1
    else:
        kwargs["exc_cap"] = 1
    args = (indptr, b2, counts, s, e, width)
    for lib in (t_native, j_native):
        if variant == "u16":
            out = lib.band_scatter_counts_indptr(*args)
        elif variant == "u8":
            out = lib.band_scatter_counts_u8_indptr(*args, **kwargs)
        else:
            out = lib.band_scatter_counts_u4_indptr(*args, 4, **kwargs)
        assert out is None


def test_exception_cap_defaults():
    """``exc_cap`` defaults to max(1024, n*width // 8) in u8 mode and
    max(1024, n*(width - d0) // 16) in u4 mode, in both libraries: just
    past the cap gives None, at it a pack."""
    n, width, d0 = 200, 96, 8
    s, e = 0, n
    flat = np.arange(n * width)
    b1, d = flat // width, flat % width
    keep = b1 + d < e
    b1, d = b1[keep], d[keep]
    b2 = b1 + d
    indptr = np.concatenate([[0], np.cumsum(np.bincount(b1, minlength=n))])
    for name, cap, big in (("u8", max(1024, n * width // 8), d >= 0),
                           ("u4", max(1024, n * (width - d0) // 16), d >= d0)):
        for n_exc in (cap, cap + 1):
            counts = np.ones(len(b1), np.int64)
            counts[np.flatnonzero(big)[:n_exc]] = 300
            for lib in (t_native, j_native):
                if name == "u8":
                    out = lib.band_scatter_counts_u8_indptr(indptr, b2, counts, s, e, width)
                else:
                    out = lib.band_scatter_counts_u4_indptr(indptr, b2, counts, s, e, width, d0)
                assert (out is None) == (n_exc > cap), (name, n_exc)


@pytest.mark.parametrize("b2_dtype", B2_DTYPES)
@pytest.mark.parametrize("dtype", COUNT_DTYPES)
@pytest.mark.parametrize("balanced", [False, True])
def test_trans_coo_balanced(balanced, dtype, b2_dtype):
    rng = np.random.RandomState(6)
    n1, s2, e2 = 60, 100, 180
    per_row = rng.randint(0, 30, n1)
    b2 = np.concatenate([np.sort(rng.choice(np.arange(40, 260), k, replace=False))
                         for k in per_row]).astype(b2_dtype)
    counts = rng.poisson(3, len(b2)).astype(dtype)
    indptr = 500 + np.concatenate([[0], np.cumsum(per_row)])
    w1 = w2 = None
    if balanced:
        w1, w2 = rng.rand(n1) + 0.5, rng.rand(e2 - s2) + 0.5
        w1[[3, 17]] = np.nan
    out = t_native.trans_coo_balanced(indptr, b2, counts, s2, e2, w1, w2)
    ref = j_native.trans_coo_balanced(indptr, b2, counts, s2, e2, w1, w2)
    assert [a.dtype for a in out] == [np.int32, np.int32, np.float32]
    assert len(out[0]) > 0 and all(np.array_equal(a, b, equal_nan=True) for a, b in zip(out, ref))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coo_to_band(dtype):
    rng = np.random.RandomState(7)
    n, width = 90, 20
    rows = rng.randint(-2, n + 2, 800)
    cols = rows + rng.randint(-5, width + 5, 800)
    vals = rng.rand(800) * 10
    out = t_native.coo_to_band(rows, cols, vals, n, width, dtype=dtype)
    assert out.dtype == dtype and out.shape == (n, width)
    assert np.array_equal(out, j_native.coo_to_band(rows, cols, vals, n, width, dtype=dtype))


def written_cool(tmp_path, count_dtype=np.int64):
    """A two-chromosome cool file written by the port's ``create_cool``,
    with head counts above 255 and tail counts above 15 (pixels of both
    chromosomes and between them)."""
    rng = np.random.RandomState(8)
    n = 120
    rows, cols = np.triu_indices(n)
    keep = ((cols - rows < 40) & (rng.rand(len(rows)) < 0.7)) | (rng.rand(len(rows)) < 0.01)
    rows, cols = rows[keep], cols[keep]
    d = cols - rows
    counts = np.where(d < 6, rng.randint(1, 300, len(d)), rng.randint(0, 18, len(d)))
    bins = pd.DataFrame({"chrom": ["c1"] * 70 + ["c2"] * 50,
                         "start": np.r_[np.arange(70), np.arange(50)] * 1000,
                         "end": np.r_[np.arange(70), np.arange(50)] * 1000 + 1000,
                         "weight": rng.rand(n) + 0.5})
    path = str(tmp_path / "counts.cool")
    create_cool(path, bins, {"bin1_id": rows, "bin2_id": cols,
                             "count": counts.astype(count_dtype)})
    return path


@pytest.mark.parametrize("allow", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("head", [None, 0, 4, 15, 16])
@pytest.mark.parametrize("which", ["example", "written", "written float"])
def test_band_upper_counts_auto(which, head, allow, tmp_path, monkeypatch):
    """The same mode and arrays as the JAX ``CoolFile`` on every
    chromosome, from the file and from memory, for the u4 head width
    (``u4_head``, the JAX package's ``CHROMOSIGHT_TPU_U4_HEAD``, default
    64: u4 only while 0 < d0 <= width // 2); on the written file, whose
    counts fit, the mode the flags allow."""
    if head is not None:
        monkeypatch.setenv("CHROMOSIGHT_TPU_U4_HEAD", str(head))
    u4_head = 64 if head is None else head
    path = EXAMPLE_COOL if which == "example" else written_cool(
        tmp_path, np.float64 if which == "written float" else np.int64)
    ours, ref = CoolSource(path), JCoolFile(path)
    in_memory = ArraySource.from_source(ours)
    width, modes = 31, set()
    for chrom in ours.chromnames:
        extent = ours.extent(chrom)
        flags = {"allow_u8": allow[0], "allow_u4": allow[1]}
        pack = ours.band_upper_counts_auto(extent, width, **flags, u4_head=u4_head)
        same_pack(pack, ref.band_upper_counts_auto(extent, width, **flags))
        same_pack(pack, in_memory.band_upper_counts_auto(extent, width, **flags,
                                                         u4_head=u4_head))
        modes.add(pack[0])
    if which != "example":  # counts made to fit: the mode follows the flags
        u4 = allow == (True, True) and 0 < u4_head <= width // 2
        assert modes == {"u4" if u4 else "u8" if allow[0] else "u16"}
    # rows past the chromosome's end stay zero, as in the JAX u16 band
    extent = ours.extent(ours.chromnames[0])
    u16 = ours.band_upper_counts_auto(extent, width, n_rows=80, allow_u8=False, u4_head=u4_head)
    assert np.array_equal(u16[1], ref.band_upper_counts(extent, width, n_rows=80))


def test_band_upper_counts_auto_refuses(tmp_path, monkeypatch):
    """No native library, or non-integral counts: None, as the JAX
    package gives it."""
    path = written_cool(tmp_path, np.float64)
    src = ArraySource.from_source(CoolSource(path))
    src.count = src.count + 0.25
    assert src.band_upper_counts_auto(src.extent("c1"), 31, u4_head=8) is None
    monkeypatch.setattr(t_native, "get_lib", lambda: None)
    assert CoolSource(path).band_upper_counts_auto((0, 70), 31, u4_head=8) is None


def random_pack(mode, seed=9, n=80, width=40, d0=6):
    """A count pack of random pixels through the port's native scatter,
    its f32 band from ``band_scatter_fused`` with NaN weights at two
    rows, the weights, and the pixels."""
    indptr, b1, b2, counts, (s, e, _) = row_slice(seed, n=n, width=width, s=0, head=d0,
                                                 head_max=400, tail_max=22)
    counts[::11] = 0  # stored pixels of count 0
    weights = np.random.RandomState(seed).rand(e) + 0.5
    weights[[7, 31]] = np.nan
    if mode == "u4":
        pack = t_native.band_scatter_counts_u4_indptr(indptr, b2, counts, s, e, width, d0)
    elif mode == "u8":
        pack = t_native.band_scatter_counts_u8_indptr(indptr, b2, counts, s, e, width)
    else:
        pack = (t_native.band_scatter_counts_indptr(indptr, b2, counts, s, e, width),)
    fused = t_native.band_scatter_fused(b1, b2, counts, weights, s, e, width)
    raw = t_native.band_scatter_fused(b1, b2, counts, None, s, e, width)
    return pack, fused, raw, weights, (b1, b2, counts)


def port_finalize(mode, pack, weights, width):
    args = [torch.from_numpy(a) for a in pack]
    if mode != "u16":
        args[-2] = args[-2].to(torch.int32)
    band = t_band.band_unpack(mode, args, width)
    if weights is not None:
        band = t_band.band_weighted(band, torch.from_numpy(weights))
    return band.numpy()


def jax_finalize(mode, pack, weights, width):
    if mode != "u16":
        pack = (*pack[:-2], pack[-2].astype(np.int32), pack[-1])
    if weights is None:
        if mode == "u4":
            return np.asarray(j_band.band_counts_finalize_u4(*pack, width, width))
        if mode == "u8":
            return np.asarray(j_band.band_counts_finalize_u8(*pack, width))
        return np.asarray(j_band.band_finalize_upload(pack[0], width))
    w = weights.astype(np.float32)
    if mode == "u4":
        return np.asarray(j_band.band_weighted_finalize_u4(*pack, w, width, width))
    if mode == "u8":
        return np.asarray(j_band.band_weighted_finalize_u8(*pack, w, width))
    return np.asarray(j_band.band_weighted_finalize(pack[0], w, width))


@pytest.mark.parametrize("mode", ["u4", "u8", "u16"])
def test_finalize_raw_matches_jax(mode):
    """Raw counts unpacked on the device: bit for bit the JAX
    finalizers' and the host's f32 band, at an odd and an even number of
    tail columns."""
    for width in (37, 38):
        pack, _, raw, _, _ = random_pack(mode, width=width)
        ours = port_finalize(mode, pack, None, width)
        assert ours.dtype == np.float32 and ours.shape == (80, width)
        assert np.array_equal(ours, jax_finalize(mode, pack, None, width))
        assert np.array_equal(ours, raw) and ours.max() > 255


@pytest.mark.parametrize("mode", ["u4", "u8", "u16"])
def test_finalize_weighted(mode):
    """Counts balanced on the device: bit for bit ``band_scatter_fused``
    except at stored pixels of count 0 in a row or column of NaN weight
    (NaN on the host, 0 here: the one listed difference), and within
    1e-5 relative of the JAX float32 product."""
    pack, fused, _, weights, (b1, b2, counts) = random_pack(mode, width=38)
    ours = port_finalize(mode, pack, weights, 38)
    assert ours.dtype == np.float32 and ours.shape == (80, 38)
    zero_nan = np.zeros(fused.shape, bool)
    d = b2 - b1
    kept = (d < 38) & (b2 < 80)
    zero_nan[b1[kept], d[kept]] = (counts[kept] == 0) & np.isnan(fused[b1[kept], d[kept]])
    assert zero_nan.sum() > 0 and np.isnan(fused).sum() > zero_nan.sum()
    assert not ours[zero_nan].any()
    assert np.array_equal(ours[~zero_nan], fused[~zero_nan], equal_nan=True)
    # after the NaN zeroing of preprocess, no exception at all
    assert np.array_equal(np.nan_to_num(ours, nan=0.0), np.nan_to_num(fused, nan=0.0))
    ref = jax_finalize(mode, pack, weights, 38)
    ok = np.isfinite(ours) & (ours != 0)
    assert np.array_equal(np.isnan(ours), np.isnan(ref))
    assert np.max(np.abs(ref[ok] - ours[ok]) / np.abs(ours[ok])) < 1e-5


def band_maps(path, norm, device="cpu"):
    """Each band map of ``path`` made (``create_mat``) with the loops
    preset: {name: preprocessed band as numpy}."""
    genome = HicGenome(path, kernel_config=dict(loops), device=device)
    with contextlib.redirect_stderr(io.StringIO()):
        genome.normalize(norm)
    genome.compute_max_dist()
    genome.make_sub_matrices()
    bands = {}
    for cm in genome.sub_mats.contact_map:
        cm.create_mat()
        bands[cm.name] = cm.band_dev.numpy()
        cm.destroy_mat()
    return bands


@pytest.mark.parametrize("mode", ["u4", "u8", "u16"])
@pytest.mark.parametrize("norm", ["auto", "raw"])
def test_create_mat_count_path_bitwise(norm, mode, monkeypatch):
    """Each band map of the example ships packed counts in ``mode``, and
    its preprocessed band equals the f32 path's bit for bit."""
    set_mode(monkeypatch, None)
    want = band_maps(EXAMPLE_COOL, norm)
    assert set(uploaded_modes().values()) == {"f32"}
    set_mode(monkeypatch, mode)
    got = band_maps(EXAMPLE_COOL, norm)
    modes = uploaded_modes()
    assert modes.keys() == want.keys() == got.keys() and set(modes.values()) == {mode}
    for name in want:
        assert got[name].dtype == np.float32
        assert got[name].tobytes() == want[name].tobytes(), name


@pytest.mark.parametrize("mode", ["u4", "u8", "u16"])
def test_golden_loops_through_count_path(mode, tmp_path, monkeypatch):
    """``detect`` of data_test/example.cool through the count path: the
    table and windows byte for byte the f32 path's, and the 89 golden
    calls within the goldens' tolerances."""
    outs = {}
    for path_mode in (None, mode):
        set_mode(monkeypatch, path_mode)
        prefix = str(tmp_path / str(path_mode))
        with contextlib.redirect_stderr(io.StringIO()):
            assert main(["detect", "--no-plotting", EXAMPLE_COOL, prefix], device="cpu") == 0
        outs[path_mode] = (pathlib.Path(prefix + ".tsv").read_bytes()
                           + pathlib.Path(prefix + ".json").read_bytes())
        assert set(uploaded_modes().values()) == {path_mode or "f32"}
    assert outs[mode] == outs[None]
    golden = pd.read_csv(GOLDEN, sep="\t")
    table = pd.read_csv(str(tmp_path / mode) + ".tsv", sep="\t")
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(table) == 89 and table[key].equals(golden[key])
    assert np.abs(table.score - golden.score).max() < 5e-5
    assert np.abs(table.pvalue - golden.pvalue).max() < 1e-5


def test_count_path_upload_bytes():
    """By default a map takes the count path: its upload bytes are
    exactly the pack's arrays, its exceptions as int32 indices and
    float32 values, and the rows' float64 weights."""
    assert t_cm.COUNT_PACKING == "u4"
    genome = HicGenome(EXAMPLE_COOL, kernel_config=dict(loops), device="cpu")
    genome.normalize("auto")
    genome.compute_max_dist()
    genome.make_sub_matrices()
    for cm in genome.sub_mats.contact_map:
        (s, e), _ = cm.extent
        pack = cm.clr.band_upper_counts_auto((s, e), cm.keep_distance + 1,
                                             u4_head=t_cm.U4_HEAD)
        want = sum(a.nbytes for a in pack[1:-2]) + 8 * len(pack[-1]) + 8 * (e - s)
        obs.reset()
        cm.create_mat()
        assert obs.snapshot()[2]["upload"] == want
        assert obs.band_uploads() == {cm.name: {
            "mode": pack[0], "exceptions": len(pack[-1]),
            "shape": (e - s, cm.keep_distance + 1)}}
        cm.destroy_mat()


@pytest.mark.parametrize("which", ["cool", "memory"])
@pytest.mark.parametrize("balance", [False, True])
def test_trans_coo_raw(balance, which, monkeypatch):
    """The trans fetch through the native function: the same triplets as
    its numpy fallback and as the JAX package's native fetch, on every
    trans pair of the example."""
    src = CoolSource(EXAMPLE_COOL)
    if which == "memory":
        src = ArraySource.from_source(src)
    ref = JCoolFile(EXAMPLE_COOL)
    names = src.chromnames
    pairs = [(a, b) for i, a in enumerate(names) for b in names[i + 1:]]
    native_out = {p: src.trans_coo_raw(src.extent(p[0]), src.extent(p[1]), balance)
                  for p in pairs}
    monkeypatch.setattr(t_native, "trans_coo_balanced", lambda *args: None)
    for pair in pairs:
        e1, e2 = src.extent(pair[0]), src.extent(pair[1])
        out = native_out[pair]
        assert [a.dtype for a in out] == [np.int32, np.int32, np.float32] and len(out[0]) > 0
        for want in (src.trans_coo_raw(e1, e2, balance), ref.trans_coo_raw(e1, e2, balance)):
            assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(out, want))
            assert [a.dtype for a in want] == [np.int32, np.int32, np.float32]
    assert src.trans_coo_raw(src.extent(names[1]), src.extent(names[0])) is None


def test_subsampled_band_native_matches_numpy(monkeypatch):
    """``--subsample``'s band through the native ``coo_to_band`` equals
    its numpy fallback."""
    genome = HicGenome(EXAMPLE_COOL, kernel_config=dict(loops), device="cpu",
                       sample=0.5, rng=np.random.RandomState(0))
    genome.normalize("auto")
    genome.compute_max_dist()
    genome.make_sub_matrices()
    cm = genome.sub_mats.contact_map[1]
    width = cm.keep_distance + 1
    cm.rng = np.random.RandomState(3)
    ours = cm._subsampled_band(width, cm.sample, cm.use_norm)
    monkeypatch.setattr(t_native, "coo_to_band", lambda *args, **kwargs: None)
    cm.rng = np.random.RandomState(3)
    fallback = cm._subsampled_band(width, cm.sample, cm.use_norm)
    assert ours.dtype == np.float32 and ours.shape == (cm.shape[0], width)
    assert ours.any() and np.array_equal(ours, fallback, equal_nan=True)


def test_pixels_bin1_id_never_read(tmp_path, monkeypatch):
    """``band_upper_counts_auto``, ``row_slice_raw``, ``trans_coo_raw``,
    a count-path ``create_mat`` and ICE's CSR prep read ``bin2_id`` and
    ``count`` of a ``CoolSource``, never ``bin1_id``."""
    from chromosight_torch.ops.balance import ice_balance

    reads = []
    getitem = hdf5.Dataset.__getitem__

    def recording(self, key):
        reads.append(self.name.rsplit("/", 2)[-2:])
        return getitem(self, key)

    path = written_cool(tmp_path)
    src = CoolSource(path)
    monkeypatch.setattr(hdf5.Dataset, "__getitem__", recording)
    src.band_upper_counts_auto(src.extent("c1"), 31, u4_head=t_cm.U4_HEAD)
    src.row_slice_raw(0, 70)
    src.trans_coo_raw(src.extent("c1"), src.extent("c2"), balance=True)
    ice_balance(src, cis_only=True, store=False)
    obs.reset()
    band_maps(path, "auto")
    assert set(uploaded_modes().values()) <= {"u4", "u8", "u16"} and uploaded_modes()
    assert ["pixels", "bin2_id"] in reads and ["pixels", "count"] in reads
    assert ["pixels", "bin1_id"] not in reads
