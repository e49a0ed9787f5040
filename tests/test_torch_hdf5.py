"""The port's own HDF5 reader and writer (``chromosight_torch.io.hdf5``)
against h5py, which is the oracle here and nowhere in the port.

* Files h5py writes read back bit for bit: arrays of the same dtype and
  shape with the same bytes, attributes equal in value and in type, for
  every layout cooler and both packages' ``create_cool`` write
  (contiguous; chunked with gzip 6 and shuffle; fletcher32; a chunk
  B-tree of two levels; big-endian integers; an enum; fixed and
  variable-length strings; a group with attributes in continuation
  blocks; empty and unallocated datasets; a nested
  ``::/resolutions/1000`` group), and slices drawn across chunk
  boundaries.
* Files the port writes (``create_cool``) or modifies
  (``store_weights``) read through h5py and the JAX package's
  ``CoolFile`` as h5py's own do, and h5py can write to them again.
* Features outside the subset raise ``NotImplementedError``; the newer
  formats this file once held to that read like h5py
  (tests/test_torch_hdf5_formats.py covers them all).
* The cooler-layout fixture (tests/data/example_cooler_layout.cool,
  written by ``write_cooler_layout``) holds data_test/example.cool's
  data, and the loops golden runs from it through the port.
"""

import contextlib
import io
import pathlib
import shutil

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

h5py = pytest.importorskip("h5py")

import chromosight_torch.io.cool as tcool  # noqa: E402
import chromosight_tpu.io.cool as jcool  # noqa: E402
from chromosight_torch.cli.main import main  # noqa: E402
from chromosight_torch.io import hdf5  # noqa: E402
from chromosight_torch.io.source import CoolSource  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402, F401

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
EXAMPLE_COOL = ROOT / "data_test" / "example.cool"
FIXTURE = DATA / "example_cooler_layout.cool"
COOLER_OPTS = dict(compression="gzip", compression_opts=6, shuffle=True)
PIXEL_CHUNK = 20_000


def write_cooler_layout(src, dst):
    """``src``'s datasets and root attributes written with h5py in
    cooler's own layout: every dataset chunked with gzip 6 and shuffle,
    pixel columns resizable in chunks of ``PIXEL_CHUNK``, ``bins/chrom``
    an enum of the chromosome names.  Wrote
    tests/data/example_cooler_layout.cool from data_test/example.cool."""
    with h5py.File(src, "r") as s, h5py.File(dst, "w") as d:
        for key, value in s.attrs.items():
            d.attrs[key] = value
        names = s["chroms/name"][:]
        d.create_dataset("chroms/name", data=names, **COOLER_OPTS)
        d.create_dataset("chroms/length", data=s["chroms/length"][:], **COOLER_OPTS)
        enum = h5py.enum_dtype({n.decode(): i for i, n in enumerate(names)}, basetype="<i4")
        d.create_dataset("bins/chrom", data=s["bins/chrom"][:], dtype=enum, **COOLER_OPTS)
        for col in ("start", "end", "weight"):
            d.create_dataset(f"bins/{col}", data=s[f"bins/{col}"][:], **COOLER_OPTS)
        for col in ("bin1_id", "bin2_id", "count"):
            d.create_dataset(f"pixels/{col}", data=s[f"pixels/{col}"][:],
                             chunks=(PIXEL_CHUNK,), maxshape=(None,), **COOLER_OPTS)
        for col in ("chrom_offset", "bin1_offset"):
            d.create_dataset(f"indexes/{col}", data=s[f"indexes/{col}"][:], **COOLER_OPTS)
    return dst


# -- the files h5py writes ------------------------------------------------ #

def _contiguous(f, rng):
    f.create_dataset("i8", data=rng.randint(-9, 9, 500).astype(np.int64))
    f.create_dataset("u2", data=rng.randint(0, 9, 500).astype(np.uint16))
    f.create_dataset("f4", data=rng.rand(37, 3).astype(np.float32))
    f.create_dataset("f8", data=rng.rand(500))
    f.create_dataset("scalar", data=np.float64(2.5))
    f.create_dataset("scalar_unallocated", shape=(), dtype=np.int32, fillvalue=3)
    f.attrs["int"], f.attrs["float"], f.attrs["array"] = 7, 0.25, np.arange(4)


def _gzip_shuffle(f, rng):
    f.create_dataset("count", data=rng.randint(0, 500, 109_975).astype(np.int32),
                     chunks=(8192,), maxshape=(None,), **COOLER_OPTS)
    f.create_dataset("f8", data=rng.rand(50, 7), chunks=(8, 3), **COOLER_OPTS)


def _fletcher32(f, rng):
    f.create_dataset("f8", data=rng.rand(1001), chunks=(64,), fletcher32=True)
    f.create_dataset("i4", data=rng.randint(0, 9, 999).astype(np.int32), chunks=(100,),
                     fletcher32=True, **COOLER_OPTS)


def _deep_btree(f, rng):
    f.create_dataset("bin2_id", data=np.sort(rng.randint(0, 720, 109_975)).astype(np.int64),
                     chunks=(100,), **COOLER_OPTS)


def _big_endian(f, rng):
    f.create_dataset("i8", data=rng.randint(0, 1 << 40, 300).astype(">i8"))
    f.create_dataset("i4", data=rng.randint(0, 99, 300).astype(">i4"), chunks=(64,),
                     **COOLER_OPTS)
    f.create_dataset("f8", data=rng.rand(300).astype(">f8"))
    f.attrs["big"] = np.array([1, 2], dtype=">i2")


def _enum(f, rng):
    enum = h5py.enum_dtype({"chr1": 0, "chr2": 1, "chrM": 2}, basetype="<i4")
    f.create_dataset("chrom", data=rng.randint(0, 3, 720).astype(np.int32), dtype=enum,
                     **COOLER_OPTS)
    f.create_dataset("small", data=np.array([0, 1, 1], np.uint8),
                     dtype=h5py.enum_dtype({"a": 0, "b": 1}, basetype="u1"))


def _strings(f, rng):
    f.create_dataset("fixed", data=np.array([b"chr1", b"chr22", b""], dtype="S32"))
    f.create_dataset("vlen", data=["chr1", "chrX", ""], dtype=h5py.string_dtype())
    f.create_dataset("vlen_scalar", data="chr1", dtype=h5py.string_dtype())
    f.attrs["vlen"], f.attrs["empty"] = "HDF5::Cooler", ""
    f.attrs["utf8"] = "détecté"
    f.attrs["fixed"] = np.bytes_(b"fixed")
    f.attrs["vlen_array"] = ["a", "bb", "ccc"]
    f.attrs["fixed_array"] = np.array([b"x", b"yz"], dtype="S2")


def _many_attributes(f, rng):
    with h5py.File(EXAMPLE_COOL, "r") as src:
        for key, value in src.attrs.items():
            f.attrs[key] = value
    group = f.create_group("many")
    for i in range(40):
        group.attrs[f"a{i:02d}"] = i if i % 2 else f"value {i}"
    group.create_dataset("x", data=np.arange(3))


def _empty(f, rng):
    f.create_dataset("empty", shape=(0,), dtype=np.int64)
    f.create_dataset("empty_chunked", shape=(0,), dtype=np.int32, chunks=(10,),
                     maxshape=(None,), **COOLER_OPTS)
    f.create_dataset("unallocated", shape=(10,), dtype=np.int32, fillvalue=7)
    partial = f.create_dataset("partial", shape=(25,), dtype=np.float64, chunks=(4,),
                               fillvalue=-1.5)
    partial[9:13] = 3.0


def _nested(f, rng):
    for res in (1000, 5000):
        group = f.create_group(f"resolutions/{res}")
        group.attrs["bin-size"] = res
        group.create_dataset("pixels/count", data=rng.randint(0, 9, 300).astype(np.int32),
                             chunks=(64,), **COOLER_OPTS)


CASES = {
    "contiguous": _contiguous,
    "gzip_shuffle": _gzip_shuffle,
    "fletcher32": _fletcher32,
    "deep_btree": _deep_btree,
    "big_endian": _big_endian,
    "enum": _enum,
    "strings": _strings,
    "many_attributes": _many_attributes,
    "empty": _empty,
    "nested": _nested,
}


def h5py_file(path, case):
    with h5py.File(path, "w") as f:
        CASES[case](f, np.random.RandomState(len(case)))
    return path


def assert_same(ours, ref, what):
    """Equal in type, and arrays in dtype, shape and bytes (object arrays
    element by element)."""
    assert type(ours) is type(ref), (what, type(ours), type(ref))
    if isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, what
        if ref.dtype == object:
            assert ours.tolist() == ref.tolist(), what
            assert [type(v) for v in ours.flat] == [type(v) for v in ref.flat], what
        else:
            assert ours.tobytes() == ref.tobytes(), what
    else:
        assert ours == ref, what


def assert_attrs_same(ours, ref, what):
    assert list(ours) == sorted(ref) and set(ours) == set(ref), what
    for key in ref:
        assert_same(ours[key], ref[key], f"{what}@{key}")


def assert_reads_like_h5py(path):
    """Every object of the file: the port's reading equals h5py's."""
    seen = []
    with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
        assert_attrs_same(ours.attrs, ref.attrs, "/")

        def visit(name, obj):
            mine = ours[name]
            seen.append(name)
            assert_attrs_same(mine.attrs, obj.attrs, name)
            if isinstance(obj, h5py.Group):
                assert isinstance(mine, hdf5.Group) and sorted(mine.keys()) == sorted(obj)
                return
            assert mine.shape == obj.shape and mine.dtype == obj.dtype, name
            assert_same(mine[()], obj[()], name)
            if obj.ndim:
                n = obj.shape[0]
                for lo, hi in ((0, n), (1, n - 1), (n // 3, n // 2 + 1), (n, n + 5), (5, 2)):
                    assert_same(mine[lo:hi], obj[lo:hi], f"{name}[{lo}:{hi}]")

        ref.visititems(visit)
    return seen


@pytest.mark.parametrize("case", sorted(CASES))
def test_reads_what_h5py_wrote(tmp_path, case):
    """Bit for bit, attributes in value and type, for each layout."""
    path = h5py_file(tmp_path / f"{case}.h5", case)
    seen = assert_reads_like_h5py(path)
    assert seen
    with hdf5.File(path) as f:
        if case == "deep_btree":
            level, _, _ = f._btree(f["bin2_id"]._btree_addr, 32)
            assert level >= 1 and len(f["bin2_id"]._chunk_index()[0]) == 1100
        if case == "many_attributes":
            messages = f._messages(f["many"].addr)
            assert [kind for kind, _, _ in messages].count(hdf5.ATTRIBUTE) == 40
            first_block = int.from_bytes(f._read(f["many"].addr, 16)[8:12], "little")
            assert first_block < sum(8 + len(body) for _, body, _ in messages)
        if case == "empty":
            assert f["unallocated"]._address is None and f["empty"]._address is None
            assert f["unallocated"][:].tolist() == [7] * 10
        if case == "nested":
            assert f["resolutions/1000"].attrs["bin-size"] == 1000


@pytest.fixture(scope="module")
def chunked_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("hdf5") / "chunked.h5"
    with h5py.File(path, "w") as f:
        for seed, case in enumerate(("gzip_shuffle", "deep_btree", "fletcher32", "empty")):
            CASES[case](f.create_group(case), np.random.RandomState(seed))
    with h5py.File(path, "r") as f:
        ref = {name: f[name][()] for name in SLICED}
    return path, ref


SLICED = ["gzip_shuffle/count", "gzip_shuffle/f8", "deep_btree/bin2_id", "fletcher32/f8",
          "fletcher32/i4", "empty/partial"]


@settings(max_examples=60, deadline=None, database=None)
@given(name=st.sampled_from(SLICED),
       lo=st.integers(0, 110_000), span=st.integers(0, 20_000))
def test_slices_across_chunk_boundaries(chunked_file, name, lo, span):
    """``d[lo:hi]`` equals h5py's for slices drawn across chunk
    boundaries (and past the end), inflating only the chunks that
    overlap."""
    path, ref = chunked_file
    with hdf5.File(path) as f:
        d = f[name]
        n = d.shape[0]
        lo = lo % (n + 2)
        got = d[lo : lo + span]
        assert got.dtype == ref[name].dtype
        assert got.tobytes() == ref[name][lo : lo + span].tobytes()


# -- the subset's edge ------------------------------------------------------ #

def _latest(path):
    with h5py.File(path, "w", libver="latest") as f:
        f["x"] = np.arange(3)
    return "x"


def _lzf(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(30), compression="lzf")
    return "x"


def _scaleoffset(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(30.0), scaleoffset=2)
    return "x"


def _nbit(path):
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((10,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0)
        f.create_dataset("x", data=np.arange(30, dtype=np.int32), dcpl=dcpl)
    return "x"


def _soft_link(path):
    with h5py.File(path, "w") as f:
        f["x"] = np.arange(3)
        f["soft"] = h5py.SoftLink("/x")
    return "soft"


def _link_group(path):
    with h5py.File(path, "w") as f:
        f.create_group("g", track_order=True)["x"] = np.arange(3)
    return "g/x"


def _szip(path):
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(300, dtype=np.int32), chunks=(100,),
                         compression="szip")
    return "x"


def _virtual(path):
    source = path.parent / "source.h5"
    with h5py.File(source, "w") as f:
        f["x"] = np.arange(4)
    layout = h5py.VirtualLayout(shape=(4,), dtype="i8")
    layout[:] = h5py.VirtualSource(str(source), "x", shape=(4,))
    with h5py.File(path, "w", libver="latest") as f:
        f.create_virtual_dataset("x", layout)
    return "x"


def _virtual_unlimited(path):
    source = path.parent / "source.h5"
    with h5py.File(source, "w") as f:
        f.create_dataset("x", data=np.arange(4), maxshape=(None,), chunks=(2,))
    layout = h5py.VirtualLayout(shape=(4,), maxshape=(None,), dtype="i8")
    layout[0:h5py.h5s.UNLIMITED] = h5py.VirtualSource(
        str(source), "x", shape=(4,), maxshape=(None,))[0:h5py.h5s.UNLIMITED]
    with h5py.File(path, "w", libver="latest") as f:
        f.create_virtual_dataset("x", layout)
    return "x"


def _virtual_unlimited_inner(path):
    """A 2-D virtual dataset unlimited along its second axis, mapped by an
    unlimited selection there."""
    source = path.parent / "source.h5"
    with h5py.File(source, "w") as f:
        f.create_dataset("x", data=np.arange(8).reshape(2, 4), maxshape=(2, None), chunks=(2, 2))
    unlimited = h5py.h5s.UNLIMITED
    layout = h5py.VirtualLayout(shape=(2, 4), maxshape=(2, None), dtype="i8")
    layout[:, 0:unlimited] = h5py.VirtualSource(
        str(source), "x", shape=(2, 4), maxshape=(2, None))[:, 0:unlimited]
    with h5py.File(path, "w", libver="latest") as f:
        f.create_virtual_dataset("x", layout)
    return "x"


def _compound(path):
    with h5py.File(path, "w") as f:
        f["x"] = np.zeros(3, dtype=[("a", "<i4"), ("b", "<f8")])
    return "x"


@pytest.mark.parametrize("make", [_latest, _lzf, _link_group, _scaleoffset, _nbit, _soft_link,
                                  _szip, _virtual, _virtual_unlimited],
                         ids=["superblock_v3", "lzf", "link_group", "scaleoffset", "nbit",
                              "soft_link", "szip", "virtual", "virtual_unlimited"])
def test_newer_formats_read_like_h5py(tmp_path, make):
    """What this reader once refused (a superblock-v3 file, LZF, a group
    of link messages, the scale-offset, n-bit and szip filters, a soft
    link, a virtual dataset, an unlimited one) reads as h5py reads it
    (tests/test_torch_hdf5_formats.py, test_torch_hdf5_features.py,
    test_torch_hdf5_szip.py and test_torch_hdf5_virtual.py hold every
    newer structure)."""
    path = tmp_path / "x.h5"
    name = make(path)
    with h5py.File(path, "r") as ref, hdf5.File(path) as f:
        assert f[name][:].tobytes() == ref[name][:].tobytes()
    if make is not _soft_link:
        assert name in assert_reads_like_h5py(path)


@pytest.mark.parametrize("make", [_virtual_unlimited_inner, _compound],
                         ids=["virtual_unlimited", "compound"])
def test_outside_the_subset_raises(tmp_path, make):
    """A feature outside the subset raises NotImplementedError naming it
    and its file offset, never a wrong read."""
    path = tmp_path / "x.h5"
    name = make(path)
    with pytest.raises(NotImplementedError, match="at file offset"):
        with hdf5.File(path) as f:
            f[name][:]


def test_full_symbol_table_node_splits(tmp_path):
    """A 9th member of a group whose one symbol-table node holds 8: the
    node splits in two under the group's B-tree, and h5py reads all 9."""
    path = tmp_path / "full.h5"
    with h5py.File(path, "w") as f:
        for i in range(8):
            f[f"bins/c{i}"] = np.arange(3)
    with hdf5.File(path, "r+") as f:
        f.write_dataset("bins/weight", np.zeros(3))
        level, items, _ = f._btree(f["bins"].btree, 8)
        assert level == 0 and len(items) == 2
    with h5py.File(path, "r") as f:
        assert sorted(f["bins"]) == sorted([f"c{i}" for i in range(8)] + ["weight"])
        assert f["bins/weight"][:].tolist() == [0.0] * 3 and f["bins/c7"][:].tolist() == [0, 1, 2]
    assert_reads_like_h5py(path)


# -- what the port writes --------------------------------------------------- #

def example_tables():
    """data_test/example.cool's bins (with weights) and pixels as the
    JAX package's CoolFile gives them."""
    clr = jcool.CoolFile(str(EXAMPLE_COOL))
    with h5py.File(EXAMPLE_COOL, "r") as f:
        pixels = pd.DataFrame({c: f[f"pixels/{c}"][:] for c in ("bin1_id", "bin2_id", "count")})
    return clr.bins(), pixels


def assert_files_alike(ours, ref, skip=("generated-by",)):
    """The same datasets, dtypes, shapes and values, and the same root
    attributes in value and type (but ``skip``), through h5py."""
    with h5py.File(ours, "r") as a, h5py.File(ref, "r") as b:
        names = []
        b.visit(names.append)
        mine = []
        a.visit(mine.append)
        assert sorted(mine) == sorted(names)
        for name in names:
            if isinstance(b[name], h5py.Dataset):
                assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
                assert a[name][()].tobytes() == b[name][()].tobytes(), name
                assert_attrs_same(dict(a[name].attrs), dict(b[name].attrs), name)
        assert set(a.attrs) == set(b.attrs)
        for key in b.attrs:
            if key not in skip:
                assert_same(a.attrs[key], b.attrs[key], key)


@pytest.mark.parametrize("minimal_dtypes", [True, False])
def test_create_cool_reads_like_h5pys_file(tmp_path, minimal_dtypes):
    """``create_cool`` without h5py: h5py and the JAX package's CoolFile
    read the port's file as the file the JAX package's h5py writer makes
    from the same call; the port reads both alike; h5py writes to the
    port's file again."""
    bins, pixels = example_tables()
    shuffled = pixels.sample(frac=1.0, random_state=0)
    ours, ref = tmp_path / "ours.cool", tmp_path / "ref.cool"
    tcool.create_cool(str(ours), bins, shuffled, minimal_dtypes=minimal_dtypes,
                      metadata={"k": 1})
    jcool.create_cool(str(ref), bins, shuffled, minimal_dtypes=minimal_dtypes,
                      metadata={"k": 1})
    assert_files_alike(ours, ref)
    a, b = jcool.CoolFile(str(ours)), jcool.CoolFile(str(ref))
    assert {k: v for k, v in a.info.items() if k != "generated-by"} == {
        k: v for k, v in b.info.items() if k != "generated-by"}
    assert a.info["generated-by"] == "chromosight-torch"
    assert a.bins().equals(b.bins()) and a.chroms().equals(b.chroms())
    assert np.array_equal(a.pixels_coo((0, 720), (0, 720))[2], b.pixels_coo((0, 720), (0, 720))[2])
    for path in (ours, ref):
        src = CoolSource(str(path))
        assert_attrs_same(src.info, b.info | {"generated-by": src.info["generated-by"]}, "info")
        assert_reads_like_h5py(path)
    with h5py.File(ours, "r+") as f:
        f["bins"].create_dataset("extra", data=np.arange(720))
        f.attrs["note"] = "written by h5py"
        del f["chroms/length"]
    assert_reads_like_h5py(ours)


def test_create_cool_with_columns_as_a_dict(tmp_path):
    """Pixels as a dict of numpy columns, already sorted: the same file."""
    bins, pixels = example_tables()
    a, b = tmp_path / "a.cool", tmp_path / "b.cool"
    tcool.create_cool(str(a), bins, pixels)
    tcool.create_cool(str(b), bins, {c: pixels[c].to_numpy() for c in pixels})
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("name", ["weight", "zz_last", "mid", "w" * 150],
                         ids=["replace", "sorts_last", "sorts_between", "moves_heap"])
@pytest.mark.parametrize("layout", ["h5py_contiguous", "cooler_layout", "port_written"])
def test_store_weights_reads_like_h5pys(tmp_path, layout, name):
    """``store_weights`` on a copy, and ``del`` + ``create_dataset`` with
    h5py (what the JAX package's ``store_weights`` does) on another: h5py
    and the JAX package's CoolFile read both alike, and h5py writes to the
    port's file again; replacing twice stays readable."""
    src = {"h5py_contiguous": EXAMPLE_COOL, "cooler_layout": FIXTURE}.get(layout)
    ours, ref = tmp_path / "ours.cool", tmp_path / "ref.cool"
    if src is None:
        tcool.create_cool(str(ours), *example_tables())
        shutil.copy(ours, ref)
    else:
        shutil.copy(src, ours)
        shutil.copy(src, ref)
    weights = np.random.RandomState(1).rand(720)
    weights[::7] = np.nan
    stats = {"mad_max": 5, "min_nnz": 10, "ignore_diags": 2, "tol": 1e-5}
    with hdf5.File(ours) as f:
        heap = f["bins"].heap
        segment = f._local_heap(heap)[2]
    source = CoolSource(str(ours))
    source.store_weights(weights * 2, name=name, stats=stats)
    source.store_weights(weights, name=name, stats=stats)
    with hdf5.File(ours) as f:
        assert (f._local_heap(heap)[2] != segment) == (len(name) > 100)
    jcool.CoolFile(str(ref)).store_weights(weights, name=name, stats=stats)
    assert_files_alike(ours, ref)
    with h5py.File(ours, "r") as f:
        assert f[f"bins/{name}"][:].tobytes() == weights.tobytes()
        expect = {"mad_max": np.int64(5), "min_nnz": np.int64(10),
                  "ignore_diags": np.int64(2), "tol": np.float64(1e-5)}
        assert_attrs_same(dict(f[f"bins/{name}"].attrs), expect, name)
    if name == "weight":
        assert jcool.CoolFile(str(ours)).weights.tobytes() == weights.tobytes()
        assert CoolSource(str(ours)).weights.tobytes() == weights.tobytes()
    with h5py.File(ours, "r+") as f:
        f["bins"].create_dataset("again", data=np.arange(720))
        f["bins"].attrs["x"] = 1
    assert_reads_like_h5py(ours)
    with hdf5.File(ours) as f:
        assert f["bins/again"][:].tolist() == list(range(720))


def test_store_weights_in_a_nested_group(tmp_path):
    """``file.cool::/resolutions/1000``: weights go to that group's bins;
    CoolSource reads the group's tables and attributes as the JAX
    package's CoolFile does."""
    path = tmp_path / "multi.mcool"
    with h5py.File(EXAMPLE_COOL, "r") as s, h5py.File(path, "w") as d:
        for res in ("1000", "2000"):
            s.copy(s["/"], d, name=f"resolutions/{res}")
            for key, value in s.attrs.items():
                d[f"resolutions/{res}"].attrs[key] = value
    uri = f"{path}::/resolutions/1000"
    ours, ref = CoolSource(uri), jcool.CoolFile(uri)
    assert_attrs_same(ours.info, ref.info, "info")
    assert ours.chromnames == ref.chromnames and ours.nnz == ref.nnz
    assert np.array_equal(ours.weights, ref.weights, equal_nan=True)
    ours.store_weights(np.ones(720), name="ones", stats={"mad_max": 3})
    with h5py.File(path, "r") as f:
        assert f["resolutions/1000/bins/ones"][:].tolist() == [1.0] * 720
        assert "ones" not in f["resolutions/2000/bins"]


@pytest.mark.parametrize("path", [EXAMPLE_COOL, FIXTURE], ids=["example", "cooler_layout"])
def test_cool_source_matches_jax_cool_file(path):
    """CoolSource's tables and ``info`` (key for key, type for type) equal
    the JAX package's CoolFile's; pixel slices equal h5py's."""
    ours, ref = CoolSource(str(path)), jcool.CoolFile(str(path))
    assert_attrs_same(ours.info, ref.info, "info")
    assert ours.chromnames == ref.chromnames and ours.binsize == ref.binsize
    assert np.array_equal(ours.weights, ref.weights, equal_nan=True)
    assert np.array_equal(ours._bin1_offset, ref._bin1_offset)
    with h5py.File(path, "r") as f:
        for lo, hi in ((0, 109_975), (19_990, 40_010), (109_000, 109_975)):
            for got, col in zip(ours._pixels(lo, hi), ("bin1_id", "bin2_id", "count")):
                assert got.tobytes() == f[f"pixels/{col}"][lo:hi].tobytes()
    for s, e in ((0, 720), (100, 300)):
        for a, b in zip(ours.pixels_coo((s, e), (s, e), balance=True),
                        ref.pixels_coo((s, e), (s, e), balance=True)):
            assert np.array_equal(a, b, equal_nan=True)


# -- the cooler-layout fixture ---------------------------------------------- #

def test_cooler_layout_fixture_holds_the_example(tmp_path):
    """tests/data/example_cooler_layout.cool: data_test/example.cool's
    datasets and attributes through h5py, in cooler's layout; the helper
    writes it again with the same contents."""
    with h5py.File(FIXTURE, "r") as a, h5py.File(EXAMPLE_COOL, "r") as b:
        assert_attrs_same(dict(a.attrs), dict(b.attrs), "/")
        names = []
        b.visit(names.append)
        for name in names:
            if isinstance(b[name], h5py.Dataset):
                assert a[name].dtype == b[name].dtype, name
                assert a[name][:].tobytes() == b[name][:].tobytes(), name
                assert a[name].compression == "gzip" and a[name].shuffle, name
        assert h5py.check_enum_dtype(a["bins/chrom"].dtype) == {"chr1": 0, "chr2": 1, "chr3": 2}
        assert a["pixels/count"].chunks == (PIXEL_CHUNK,)
    again = write_cooler_layout(EXAMPLE_COOL, tmp_path / "again.cool")
    assert_files_alike(again, FIXTURE, skip=())


def test_loops_golden_from_cooler_layout_fixture(tmp_path):
    """The 89 loops of tests/data/golden_detect_loops.tsv from the
    cooler-layout fixture, through the port's reader, on CPU."""
    prefix = str(tmp_path / "out")
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        assert main(["detect", "--no-plotting", str(FIXTURE), prefix], device="cpu") == 0
    g = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    o = pd.read_csv(prefix + ".tsv", sep="\t")
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    assert len(o) == len(g) == 89
    assert o[key].equals(g[key])
    assert np.abs(g.score - o.score).max() < 5e-5
    assert np.abs(g.pvalue - o.pvalue).max() < 1e-6
