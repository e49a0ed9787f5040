"""The port's HDF5 reader and writer (``chromosight_torch.io.hdf5`` and
``hdf5_index``) on the newer file formats, against h5py, which is the
oracle here and nowhere in the port.

* Files h5py writes at every library-version bound, in every layout and
  chunk index (contiguous, compact, single chunk, implicit, fixed array,
  extensible array, v2 B-tree), with every filter the port reads (none,
  gzip + shuffle, fletcher32, LZF), with groups of 3, 20 and 2,000 links
  and 3, 13 and 2,000 attributes (creation order tracked or not, one
  attribute past the fractal heap's managed limit) read back as h5py
  reads them: the same bytes, dtypes and shapes, attributes and links in
  h5py's order with h5py's types; each case checks, through the
  structures the reader walked (``File.walked``), that it reached the
  structure it was built for, down to extensible-array super blocks and
  paged data blocks, fixed-array pages, v2 B-trees of depth 2 and
  fractal-heap indirect blocks.
* ``store_weights`` and ``File.unlink`` on a superblock-v3 file, a
  compact group that tracks creation order, and a full symbol-table node:
  h5py and the JAX package's ``CoolFile`` read the result, every earlier
  object unchanged, and h5py writes to it again.
* The committed fixtures tests/data/example_latest.cool and
  example_latest.mcool hold data_test/example.cool's tables, read through
  ``CoolSource`` as the JAX package's ``CoolFile`` reads them, and give
  the loops, borders and quantify goldens through the port's CLI;
  ``--norm force`` on a weightless newer-format copy writes the weights
  it writes into a copy of example.cool, bit for bit.
* What stays outside the subset raises ``NotImplementedError``.
"""

import contextlib
import io
import pathlib
import shutil

import numpy as np
import pandas as pd
import pytest

h5py = pytest.importorskip("h5py")

import chromosight_tpu.io.cool as jcool  # noqa: E402
from chromosight_torch.cli.main import main  # noqa: E402
from chromosight_torch.io import hdf5, hdf5_index, load_cool  # noqa: E402
from chromosight_torch.io.source import CoolSource  # noqa: E402
from test_torch_hdf5 import assert_same  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402, F401

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
EXAMPLE_COOL = ROOT / "data_test" / "example.cool"
LATEST_COOL = DATA / "example_latest.cool"
LATEST_MCOOL = DATA / "example_latest.mcool"
COOLER_OPTS = dict(compression="gzip", compression_opts=6, shuffle=True)
PIXEL_CHUNK = 20_000
BIN_CHUNK = 256
# the resolutions of the .mcool fixture; the finest is the example's own
RESOLUTIONS = (1000, 2000, 5000, 10_000, 20_000, 50_000, 100_000, 200_000, 500_000)
LIBVERS = ("earliest", "v108", "v110", "v112", "v114", "latest")


# -- the committed fixtures --------------------------------------------- #

def example_columns(src=EXAMPLE_COOL):
    """{path: array} of ``src``'s datasets and its root attributes."""
    with h5py.File(src, "r") as s:
        columns = {}
        s.visititems(lambda name, obj: columns.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
        return columns, dict(s.attrs)


def coarsened(columns, attrs, res):
    """The example's tables binned at ``res`` bp (counts summed, no
    weights), as cooler's ``zoomify`` makes a coarser resolution."""
    lengths = columns["chroms/length"].astype(np.int64)
    nbins = -(-lengths // res)
    offsets = np.concatenate([[0], np.cumsum(nbins)])
    chrom = np.repeat(np.arange(len(lengths), dtype=np.int32), nbins)
    start = (np.arange(offsets[-1]) - offsets[chrom]) * res
    end = np.minimum(start + res, lengths[chrom])
    old_chrom = columns["bins/chrom"].astype(np.int64)
    new_bin = offsets[old_chrom] + columns["bins/start"] // res
    b1 = new_bin[columns["pixels/bin1_id"]]
    b2 = new_bin[columns["pixels/bin2_id"]]
    pairs, inverse = np.unique(b1 * offsets[-1] + b2, return_inverse=True)
    count = np.bincount(inverse, weights=columns["pixels/count"]).astype(np.int32)
    bin1, bin2 = pairs // offsets[-1], pairs % offsets[-1]
    bin1_offset = np.searchsorted(bin1, np.arange(offsets[-1] + 1)).astype(np.int64)
    out = {
        "chroms/name": columns["chroms/name"], "chroms/length": columns["chroms/length"],
        "bins/chrom": chrom, "bins/start": start.astype(np.int32),
        "bins/end": end.astype(np.int32), "pixels/bin1_id": bin1, "pixels/bin2_id": bin2,
        "pixels/count": count, "indexes/chrom_offset": offsets.astype(np.int64),
        "indexes/bin1_offset": bin1_offset,
    }
    info = dict(attrs, **{"bin-size": np.int64(res), "nbins": np.int64(offsets[-1]),
                          "nnz": np.int64(len(count)), "sum": np.int64(count.sum())})
    return out, info


def write_cooler_group(group, columns, attrs, pixel_opts):
    """One cooler in ``group``, in cooler's layout: chroms in one chunk,
    bins in chunks of ``BIN_CHUNK`` (an enum ``bins/chrom``), pixel
    columns resizable with ``pixel_opts``, gzip 6 and shuffle elsewhere."""
    for key, value in attrs.items():
        group.attrs[key] = value
    names = columns["chroms/name"]
    for col in ("name", "length"):
        data = columns[f"chroms/{col}"]
        group.create_dataset(f"chroms/{col}", data=data, chunks=data.shape, **COOLER_OPTS)
    enum = h5py.enum_dtype({n.decode(): i for i, n in enumerate(names)}, basetype="<i4")
    chunk = (min(BIN_CHUNK, len(columns["bins/start"])),)
    group.create_dataset("bins/chrom", data=columns["bins/chrom"], dtype=enum, chunks=chunk,
                         **COOLER_OPTS)
    for col in ("start", "end", "weight"):
        if f"bins/{col}" in columns:
            group.create_dataset(f"bins/{col}", data=columns[f"bins/{col}"], chunks=chunk,
                                 **COOLER_OPTS)
    for col in ("bin1_id", "bin2_id", "count"):
        group.create_dataset(f"pixels/{col}", data=columns[f"pixels/{col}"],
                             chunks=(PIXEL_CHUNK,), maxshape=(None,), **pixel_opts)
    for col in ("chrom_offset", "bin1_offset"):
        data = columns[f"indexes/{col}"]
        group.create_dataset(f"indexes/{col}", data=data, chunks=data.shape, **COOLER_OPTS)


def write_latest_cool(src, dst):
    """``src`` written with h5py at ``libver="latest"`` in cooler's layout
    (gzip 6, shuffle): extensible-array pixel columns, fixed-array bins,
    single-chunk chroms and indexes, 13 root attributes in dense storage.
    Wrote tests/data/example_latest.cool from data_test/example.cool."""
    columns, attrs = example_columns(src)
    with h5py.File(dst, "w", libver="latest") as d:
        write_cooler_group(d, columns, attrs, COOLER_OPTS)
    return dst


def write_latest_mcool(src, dst):
    """``src`` as a multi-resolution file at ``libver="v110"``: nine
    resolutions under ``resolutions/`` (dense link storage), the finest
    the example itself at 1,000 bp, the others binned from it; LZF on the
    pixel columns.  Wrote tests/data/example_latest.mcool."""
    columns, attrs = example_columns(src)
    with h5py.File(dst, "w", libver=("v110", "latest")) as d:
        d.attrs["format"] = "HDF5::MCOOL"
        d.attrs["format-version"] = np.int64(2)
        for res in RESOLUTIONS:
            cols, info = (columns, attrs) if res == 1000 else coarsened(columns, attrs, res)
            write_cooler_group(d.create_group(f"resolutions/{res}"), cols, info,
                               dict(compression="lzf", shuffle=True))
    return dst


# -- reading as h5py reads ------------------------------------------------ #

def h5py_chunks(dataset):
    """{chunk offset: (address, stored size, filter mask)} through h5py."""
    found = {}
    dataset.id.chunk_iter(lambda c: found.__setitem__(
        tuple(c.chunk_offset), (c.byte_offset, c.size, c.filter_mask)))
    return found


def boundary_slices(n, chunk):
    """Slices of a first axis of ``n`` rows that cross chunk boundaries,
    run past the end, or are empty."""
    c = chunk or max(n // 3, 1)
    return [(0, n), (1, n - 1), (c - 1, c + 1), (2 * c - 3, 3 * c + 2), (n - c - 1, n),
            (n // 3, n // 2 + 1), (n, n + 5), (5, 2)]


def assert_reads_like_h5py(path, full=True):
    """Every object of the file read by the port as h5py reads it:
    links and attributes in h5py's order, attribute values and types,
    datasets' dtypes, shapes and bytes (whole when ``full``) and slices
    across chunk boundaries, and every chunk's address, size and filter
    mask; the ``File.walked`` counts of the read."""
    with h5py.File(path, "r") as ref, hdf5.File(path) as ours:

        def same_attrs(mine, theirs, what):
            assert list(mine) == list(theirs), what
            for key in theirs:
                assert_same(mine[key], theirs[key], f"{what}@{key}")

        same_attrs(ours.attrs, ref.attrs, "/")
        assert list(ours.root.keys()) == list(ref.keys())

        def visit(name, obj):
            mine = ours[name]
            same_attrs(mine.attrs, obj.attrs, name)
            if isinstance(obj, h5py.Datatype):
                assert isinstance(mine, hdf5.Datatype) and mine.dtype == obj.dtype, name
                return
            if isinstance(obj, h5py.Group):
                assert isinstance(mine, hdf5.Group) and list(mine.keys()) == list(obj), name
                return
            assert mine.shape == obj.shape and mine.dtype == obj.dtype, name
            if full:
                assert_same(mine[()], obj[()], name)
            if obj.chunks is not None:
                offsets, addrs, sizes, masks = mine._chunk_index()
                # h5py gives a chunk's offset in the file, the index its
                # address after the user block
                got = {tuple(o): (int(a) + ours._base, int(s), int(m) & 0xFFFFFFFF)
                       for o, a, s, m in zip(offsets.tolist(), addrs, sizes, masks)}
                ref_chunks = h5py_chunks(obj)
                if all(all(o < n for o, n in zip(k, obj.shape)) for k in ref_chunks):
                    assert got == ref_chunks, name
                else:
                    # libhdf5's chunk_iter gives an extensible array's
                    # chunks of an unlimited second axis at offsets outside
                    # the dataset (its swizzled order): the data read above
                    # is held to h5py's, the chunks here as a set
                    assert sorted(got.values()) == sorted(ref_chunks.values()), name
            if obj.ndim:
                for lo, hi in boundary_slices(obj.shape[0], (obj.chunks or (0,))[0]):
                    assert_same(mine[lo:hi], obj[lo:hi], f"{name}[{lo}:{hi}]")

        ref.visititems(visit)
        return ours.walked


def _groups_and_attributes(f, rng):
    f.create_dataset("contiguous", data=rng.rand(100))
    f.create_dataset("chunked", data=rng.randint(0, 9, 3000), chunks=(64,), **COOLER_OPTS)
    f.create_dataset("resizable", data=rng.randint(0, 9, 3000).astype(np.int32), chunks=(100,),
                     maxshape=(None,), compression="lzf")
    f.create_dataset("checked", data=rng.rand(500), chunks=(50,), fletcher32=True)
    f.create_dataset("strings", data=["chr1", "chrX", ""], dtype=h5py.string_dtype())
    for name, n, track in (("three", 3, False), ("twenty", 20, True), ("nested/deep", 3, True)):
        group = f.create_group(name, track_order=track)
        for i in range(n):
            group[f"x{(7 * i) % n}"] = np.arange(i % 5)
    for i in range(13):
        f.attrs[f"a{(5 * i) % 13:02d}"] = i if i % 2 else f"value {i}"
    f.attrs["utf8"] = "détecté"
    f.attrs["fixed"] = np.bytes_(b"fixed")
    f.attrs["array"] = np.arange(4)


@pytest.mark.parametrize("libver", LIBVERS)
def test_library_versions_read_like_h5py(tmp_path, libver):
    """Groups, attributes, chunked and filtered datasets at every bound
    h5py offers: superblock 0 (earliest), 2 (v108) or 3 (v110 and up),
    version-2 object headers, dense attributes and links."""
    path = tmp_path / f"{libver}.h5"
    with h5py.File(path, "w", libver=libver) as f:
        _groups_and_attributes(f, np.random.RandomState(0))
    walked = assert_reads_like_h5py(path)
    superblock = {"earliest": 0, "v108": 2}.get(libver, 3)
    assert walked[f"superblock v{superblock}"] == 1
    assert walked["LZF chunk"] > 0 and walked["BTHD type 5"] >= 1
    if libver == "earliest":
        assert walked["object header v1"] > 0 and walked["BTHD type 8"] == 0
    else:
        assert walked["object header v1"] == 0 and walked["BTHD type 8"] >= 1
    if libver not in ("earliest", "v108"):
        assert walked["EAHD"] and walked["FAHD"]


def _dcpl(**settings):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if settings.get("compact"):
        dcpl.set_layout(h5py.h5d.COMPACT)
    if settings.get("early"):
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


FILTERS = {
    "none": {},
    "gzip_shuffle": COOLER_OPTS,
    "fletcher32": dict(fletcher32=True),
    "lzf": dict(compression="lzf"),
}
# layout: (dataset keywords, chunk index type, what the walk must show)
LAYOUTS = {
    "contiguous": ({}, None, None),
    "compact": (dict(dcpl=_dcpl(compact=True)), None, None),
    "single_chunk": (dict(chunks=True, single=True), 1, None),
    "implicit": (dict(chunks=True, dcpl=_dcpl(early=True)), 2, None),
    "fixed_array": (dict(chunks=True), 3, "FADB"),
    "extensible_array": (dict(chunks=True, maxshape=(None, 7)), 4, "EAIB"),
    "btree2": (dict(chunks=True, maxshape=(None, None)), 5, "BTLF"),
}
LAYOUT_CASES = [(layout, "none") for layout in ("contiguous", "compact", "implicit")] + [
    (layout, filt) for layout in ("single_chunk", "fixed_array", "extensible_array", "btree2")
    for filt in FILTERS]


@pytest.mark.parametrize("layout,filt", LAYOUT_CASES, ids=[f"{a}-{b}" for a, b in LAYOUT_CASES])
def test_layouts_read_like_h5py(tmp_path, layout, filt):
    """Each data layout and chunk index of layout version 4, with each
    filter: 1-D and 2-D datasets with partial edge chunks, chunks never
    written (the fill value), an unlimited second axis for the extensible
    array (its index runs over the chunk grid with that axis first)."""
    rng = np.random.RandomState(len(layout) + len(filt))
    kwargs, kind, signature = LAYOUTS[layout]
    path = tmp_path / "layout.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for name, data in (("i4", rng.randint(-99, 99, 1000).astype(np.int32)),
                           ("f8", rng.rand(50, 7)), ("u1", rng.randint(0, 9, 333).astype("u1"))):
            opts = {k: v for k, v in kwargs.items() if k != "single"}
            if "chunks" in opts:
                opts["chunks"] = data.shape if kwargs.get("single") else (
                    (64,) if data.ndim == 1 else (8, 3))
                if "maxshape" in opts:
                    opts["maxshape"] = opts["maxshape"][: data.ndim]
                opts.update(FILTERS[filt])
            f.create_dataset(name, data=data, fillvalue=7 if "chunks" in opts else None, **opts)
            if layout == "compact":
                opts["dcpl"] = _dcpl(compact=True)
        if "chunks" in kwargs and not kwargs.get("single"):
            opts = dict(FILTERS[filt], chunks=(4, 16), fillvalue=-1.5)
            if "maxshape" in kwargs:
                opts["maxshape"] = (None, 64) if layout == "extensible_array" else (None, None)
            if "dcpl" in kwargs:
                opts["dcpl"] = _dcpl(early=True)
            partial = f.create_dataset("partial", shape=(30, 50), dtype=np.float64, **opts)
            partial[9:13, 20:41] = rng.rand(4, 21)
        if layout == "extensible_array":
            wide = f.create_dataset("unlimited_axis_1", data=rng.rand(9, 40), chunks=(4, 6),
                                    maxshape=(9, None), **FILTERS[filt])
            wide.attrs["note"] = "unlimited second axis"
    walked = assert_reads_like_h5py(path)
    if kind is not None:
        assert walked[f"chunk index {kind}"] >= 2
    if signature is not None:
        assert walked[signature] >= 1
    if kind == 5:
        assert walked[f"BTHD type {10 if filt in ('none',) else 11}"] >= 1
    if filt == "lzf":
        assert walked["LZF chunk"] > 0
    with hdf5.File(path) as f:
        assert f["f8"]._index_type == kind
        if layout == "compact":
            assert f["f8"]._class == 0


@pytest.mark.parametrize("track_order", [False, True], ids=["by_name", "by_creation"])
@pytest.mark.parametrize("n_links", [3, 20, 2000])
def test_groups_read_like_h5py(tmp_path, n_links, track_order):
    """Groups of 3 (compact link messages), 20 and 2,000 links (dense: a
    fractal heap under a v2 B-tree of record type 5, of depth 2 for
    2,000), listed by name or by creation order as h5py lists them."""
    path = tmp_path / "groups.h5"
    with h5py.File(path, "w", libver="latest") as f:
        group = f.create_group("g", track_order=track_order)
        for i in range(n_links):
            group[f"m{(7919 * i) % n_links}"] = np.arange(i % 3)
    walked = assert_reads_like_h5py(path)
    with hdf5.File(path) as f:
        g = f["g"]
        assert g.dense == (n_links > 8)
        if g.dense:
            depth = hdf5_index.BTree2(f, g.link_info[3]).depth
            assert depth >= (2 if n_links == 2000 else 0)
            assert walked["BTHD type 5"] == 1 and walked["FHDB"] >= 1
        else:
            assert walked["FRHP"] == 0


@pytest.mark.parametrize("track_order", [False, True], ids=["by_name", "by_creation"])
@pytest.mark.parametrize("n_attrs", [3, 13, 2000, "huge"])
def test_attributes_read_like_h5py(tmp_path, n_attrs, track_order):
    """3 attributes (compact), 13 and 2,000 (dense: a fractal heap under a
    v2 B-tree of record type 8; 2,000 reach the heap's indirect blocks),
    and one attribute larger than the heap's managed objects (a huge
    object, through the heap's own B-tree), on a group and a dataset."""
    path = tmp_path / "attrs.h5"
    count = 9 if n_attrs == "huge" else n_attrs
    with h5py.File(path, "w", libver="latest") as f:
        owners = [f.create_group("g", track_order=track_order),
                  f.create_dataset("d", data=np.arange(3), track_order=track_order)]
        for owner in owners:
            for i in range(count):
                j = (37 * i) % count
                owner.attrs[f"k{j}"] = np.float32(j) if j % 3 else f"value {j}"
            if n_attrs == "huge":
                owner.attrs["big"] = np.arange(20_000, dtype=np.float64)
    walked = assert_reads_like_h5py(path)
    if n_attrs == 3:
        assert walked["FRHP"] == 0
    else:
        assert walked["BTHD type 8"] == 2
    if n_attrs == 2000:
        assert walked["FHIB"] >= 2
    if n_attrs == "huge":
        assert walked["huge object"] == 2 and walked["BTHD type 1"] == 2


DEEP = {
    # an extensible array past its first paged super block
    "extensible_array_paged": lambda f, rng: f.create_dataset(
        "x", data=rng.randint(0, 9, 140_000).astype(np.uint8), chunks=(1,), maxshape=(None,)),
    # a fixed array of three pages
    "fixed_array_paged": lambda f, rng: f.create_dataset(
        "x", data=rng.randint(0, 9, 2500).astype(np.int16), chunks=(1,), **COOLER_OPTS),
    # a chunk B-tree of depth 2
    "btree2_depth2": lambda f, rng: f.create_dataset(
        "x", data=rng.rand(80, 80).astype(np.float32), chunks=(1, 1), maxshape=(None, None)),
}
DEEP_SIGNATURES = {"extensible_array_paged": ("EASB", "EADB page"),
                   "fixed_array_paged": ("FADB page",), "btree2_depth2": ("BTIN",)}


@pytest.mark.parametrize("case", sorted(DEEP))
def test_deep_chunk_indexes(tmp_path, case):
    """Chunk indexes big enough to reach their deep levels: each chunk's
    address, size and mask as h5py's, slices across chunk boundaries."""
    path = tmp_path / "deep.h5"
    with h5py.File(path, "w", libver="latest") as f:
        DEEP[case](f, np.random.RandomState(3))
    walked = assert_reads_like_h5py(path, full=case != "extensible_array_paged")
    for signature in DEEP_SIGNATURES[case]:
        assert walked[signature] >= 1, signature
    with hdf5.File(path) as f:
        x = f["x"]
        if case == "btree2_depth2":
            assert hdf5_index.BTree2(f, x._index_addr).depth >= 2
        with h5py.File(path, "r") as ref:
            n = ref["x"].shape[0]
            for lo in (131_000, 133_100, 135_000, n - 3000):
                lo = min(lo, n - 1)
                assert x[lo : lo + 2500].tobytes() == ref["x"][lo : lo + 2500].tobytes()


def test_tiny_heap_objects(tmp_path):
    """A fractal heap ID of type 2 holds its object itself (short form:
    length - 1 in the low bits of the first byte)."""
    path = tmp_path / "attrs.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(20):
            f.attrs[f"a{i}"] = i
    with hdf5.File(path) as f:
        body = f._messages(f.root.addr)
        info = next(b for kind, b, _ in body if kind == hdf5.ATTRIBUTE_INFO)
        heap = hdf5_index.FractalHeap(f, f._addr(info, 2))
        assert heap.id_len == 8
        assert heap.get(bytes([0x20 | 4]) + b"abcde" + b"\0\0", 0) == b"abcde"
        assert f.walked["tiny object"] == 1


@pytest.mark.parametrize("signature", [b"superblock", b"OHDR", b"FADB", b"EAIB", b"BTLF",
                                       b"FHDB"])
def test_checksum_mismatch_raises(tmp_path, signature):
    """A byte changed inside a checksummed structure is an OSError naming
    the structure, never a wrong read."""
    path = shutil.copy(LATEST_COOL, tmp_path / "bad.cool")
    raw = bytearray(pathlib.Path(path).read_bytes())
    at = 20 if signature == b"superblock" else raw.index(signature) + 8
    raw[at] ^= 0xFF
    pathlib.Path(path).write_bytes(bytes(raw))
    with pytest.raises(OSError, match="checksum mismatch"):
        with hdf5.File(path) as f:
            read_everything(f)


def read_everything(f):
    """Read every attribute and every dataset of ``f`` with the port."""
    stack = [f.root]
    while stack:
        group = stack.pop()
        dict(group.attrs)
        for name in group.keys():
            obj = group[name]
            if isinstance(obj, hdf5.Group):
                stack.append(obj)
            else:
                obj[()]


# -- what stays outside the subset --------------------------------------- #

def _user_block(path):
    """A user block of 512 bytes before 2-byte offsets and lengths."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_userblock(512)
    fcpl.set_sizes(2, 2)
    with h5py.File(h5py.h5f.create(bytes(path), h5py.h5f.ACC_TRUNC, fcpl=fcpl)) as f:
        f["bins/start"] = np.arange(3)


def _small_offsets(path):
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(2, 2)
    with h5py.File(h5py.h5f.create(bytes(path), h5py.h5f.ACC_TRUNC, fcpl=fcpl)) as f:
        f["bins/start"] = np.arange(3)


@pytest.mark.parametrize("make", [_user_block, _small_offsets],
                         ids=["user_block", "small_offsets"])
def test_writing_outside_the_subset_raises(tmp_path, make):
    """Writing past what a file's offsets address (2-byte offsets: 64 KiB,
    user block included) raises OSError (EFBIG) before a byte is
    written: the file is left as h5py wrote it.  Within reach the port
    writes to such files (every size and user block: see
    tests/test_torch_hdf5_userblock.py), and h5py reads what it wrote."""
    path = tmp_path / "w.h5"
    make(path)
    before = path.read_bytes()
    with hdf5.File(path, "r+") as f, pytest.raises(OSError, match="2-byte offsets"):
        f.write_dataset("bins/weight", np.zeros(9000))
    assert path.read_bytes() == before
    assert_reads_like_h5py(path)
    with hdf5.File(path, "r+") as f:
        f.write_dataset("bins/weight", np.arange(3.0))
    with h5py.File(path, "r") as f:
        assert f["bins/weight"][()].tolist() == [0.0, 1.0, 2.0]
        assert f["bins/start"][()].tolist() == [0, 1, 2]
    assert_reads_like_h5py(path)


# -- writing into the newer formats ------------------------------------- #

def _weightless(src, dst):
    """A copy of ``src`` without bins/weight, dropped by ``File.unlink``."""
    shutil.copy(src, dst)
    with hdf5.File(dst, "r+") as f:
        f.unlink("bins/weight")
    return dst


def _track_order_cool(src, dst):
    """``src`` at libver "latest" with every group tracking creation order
    (bins holds chrom, start, end and weight as compact link messages)."""
    columns, attrs = example_columns(src)
    with h5py.File(dst, "w", libver="latest", track_order=True) as d:
        write_cooler_group(d, columns, attrs, COOLER_OPTS)
    return dst


def _full_node_cool(src, dst):
    """``src`` at the default libver with eight bins columns, a full
    symbol-table node (as a cooler converted from .hic files holds)."""
    columns, attrs = example_columns(src)
    for name in ("KR", "VC", "VC_SQRT", "extra"):
        columns[f"bins/{name}"] = columns["bins/weight"] * len(name)
    with h5py.File(dst, "w") as d:
        for key, value in attrs.items():
            d.attrs[key] = value
        for name, value in columns.items():
            d.create_dataset(name, data=value)
    with h5py.File(dst, "r") as d:
        assert len(d["bins"]) == 8
    return dst


STORE_CASES = {"superblock_v3": lambda s, d: shutil.copy(s, d),
               "track_order": _track_order_cool, "full_node": _full_node_cool}


def assert_objects_unchanged(path, before, skip=()):
    """Every dataset and attribute of ``before`` ({name: (bytes, attrs)})
    read the same through h5py from ``path``, but ``skip``."""
    with h5py.File(path, "r") as f:
        assert_same(dict(f.attrs), before["/"], "/")
        for name, value in before.items():
            if name == "/" or name in skip:
                continue
            raw, attrs = value
            assert f[name][()].tobytes() == raw, name
            assert_same(dict(f[name].attrs), attrs, name)


def h5py_objects(path):
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = dict(f.attrs)
        f.visititems(lambda n, o: out.__setitem__(n, (o[()].tobytes(), dict(o.attrs)))
                     if isinstance(o, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("case", sorted(STORE_CASES))
def test_store_weights_into_newer_formats(tmp_path, case):
    """``store_weights`` adds a column and replaces one in a superblock-v3
    file, a compact group that tracks creation order (links in h5py's
    order after h5py's del and create) and a full symbol-table node
    (split in two):
    h5py and the JAX package's CoolFile read the columns, every earlier
    object is unchanged, the JAX package's own ``store_weights`` on a
    copy gives the same file contents, and h5py writes to it again."""
    ours, ref = tmp_path / "ours.cool", tmp_path / "ref.cool"
    STORE_CASES[case](LATEST_COOL if case == "superblock_v3" else EXAMPLE_COOL, ours)
    shutil.copy(ours, ref)
    before = h5py_objects(ours)
    weights = np.random.RandomState(2).rand(720)
    weights[::9] = np.nan
    stats = {"mad_max": 5, "tol": 1e-5}
    source = CoolSource(str(ours))
    for name in ("ICE", "weight"):
        source.store_weights(weights, name=name, stats=stats)
        jcool.CoolFile(str(ref)).store_weights(weights, name=name, stats=stats)
    assert_objects_unchanged(ours, before, skip=("bins/weight",))
    with h5py.File(ours, "r") as f, h5py.File(ref, "r") as g:
        for name in ("ICE", "weight"):
            assert f[f"bins/{name}"][:].tobytes() == weights.tobytes()
            assert_same(dict(f[f"bins/{name}"].attrs), dict(g[f"bins/{name}"].attrs), name)
        assert list(f["bins"]) == list(g["bins"])
    assert jcool.CoolFile(str(ours)).weights.tobytes() == weights.tobytes()
    assert CoolSource(str(ours)).weights.tobytes() == weights.tobytes()
    with hdf5.File(ours) as f:
        if case == "full_node":
            level, items, _ = f._btree(f["bins"].btree, 8)
            assert level == 0 and len(items) == 2
        else:
            assert f.walked["superblock v3"] == 1 and f["bins"].link_info is not None
    with h5py.File(ours, "r+") as f:
        f["bins"].create_dataset("again", data=np.arange(720))
        f.attrs["note"] = "written by h5py"
    walked = assert_reads_like_h5py(ours)
    assert walked["superblock v3" if case != "full_node" else "superblock v0"] == 1


def test_unlink_then_add_in_a_compact_group(tmp_path):
    """``File.unlink`` turns a link message into a NIL message that the
    next link fills; a new link that finds no room goes into a new
    continuation chunk (OCHK) with the message it displaces."""
    path = tmp_path / "u.cool"
    _weightless(LATEST_COOL, path)
    before = h5py_objects(LATEST_COOL)
    with h5py.File(path, "r") as f:
        assert "weight" not in f["bins"] and list(f["bins"]) == ["chrom", "end", "start"]
    assert_objects_unchanged(path, before, skip=("bins/weight",))
    with hdf5.File(path, "r+") as f:
        chunks = len(f._v2_chunks(f["bins"].addr)[1])
        for i in range(4):
            f.write_dataset(f"bins/w{i}", np.full(720, float(i)))
        f.write_dataset("bins/poids_é", np.ones(720))
        assert len(f._v2_chunks(f["bins"].addr)[1]) > chunks
    with h5py.File(path, "r") as f:
        assert [f[f"bins/w{i}"][0] for i in range(4)] == [0.0, 1.0, 2.0, 3.0]
        assert f["bins/poids_é"][:].sum() == 720
    assert_objects_unchanged(path, before, skip=("bins/weight",))
    assert_reads_like_h5py(path)


# -- the committed fixtures ---------------------------------------------- #

FIXTURES = {"cool": str(LATEST_COOL), "mcool": f"{LATEST_MCOOL}::/resolutions/1000"}


def test_fixtures_hold_the_example(tmp_path):
    """tests/data/example_latest.{cool,mcool}: through h5py, the example's
    datasets and attributes, in the structures they were written for;
    the helpers write them again with the same contents."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    for uri in FIXTURES.values():
        path, _, group = uri.partition("::")
        with h5py.File(path, "r") as f:
            g = f[group or "/"]
            assert_same(dict(g.attrs), attrs, uri)
            for name, value in columns.items():
                assert g[name].dtype == value.dtype and g[name][()].tobytes() == value.tobytes()
    with h5py.File(LATEST_MCOOL, "r") as f:
        assert sorted(int(r) for r in f["resolutions"]) == sorted(RESOLUTIONS)
        assert f["resolutions/1000/pixels/count"].compression == "lzf"
    walked = {key: assert_reads_like_h5py(uri.partition("::")[0]) for key, uri in FIXTURES.items()}
    assert walked["cool"]["superblock v3"] and walked["cool"]["BTHD type 8"] == 1
    assert walked["cool"]["EAHD"] == 3 and walked["cool"]["FAHD"] == 4
    assert walked["mcool"]["BTHD type 5"] == 1 and walked["mcool"]["LZF chunk"] > 0
    again = tmp_path / "again.cool"
    write_latest_cool(EXAMPLE_COOL, again)
    write_latest_mcool(EXAMPLE_COOL, tmp_path / "again.mcool")
    for a, b in ((again, LATEST_COOL), (tmp_path / "again.mcool", LATEST_MCOOL)):
        assert h5py_objects(a).keys() == h5py_objects(b).keys()
        for name, value in h5py_objects(b).items():
            if name != "/":
                assert h5py_objects(a)[name][0] == value[0], name


@pytest.mark.parametrize("key", sorted(FIXTURES))
def test_cool_source_of_fixtures_matches_jax_cool_file(key):
    """CoolSource and load_cool of the fixtures: bins, weights, pixels and
    ``info`` (key for key, type for type) as the JAX package's CoolFile
    and load_cool give them."""
    from chromosight_tpu.io import load_cool as jload_cool

    uri = FIXTURES[key]
    ours, ref = CoolSource(uri), jcool.CoolFile(uri)
    assert list(ours.info) == sorted(ref.info)
    for name in ref.info:
        assert_same(ours.info[name], ref.info[name], name)
    assert ours.chromnames == ref.chromnames and ours.binsize == ref.binsize
    assert np.array_equal(ours.weights, ref.weights, equal_nan=True)
    path, _, group = uri.partition("::")
    with h5py.File(path, "r") as f:
        for lo, hi in ((0, ours.nnz), (19_990, 40_010)):
            for got, col in zip(ours._pixels(lo, hi), ("bin1_id", "bin2_id", "count")):
                assert got.tobytes() == f[f"{group}/pixels/{col}"][lo:hi].tobytes()
    for a, b in zip(ours.pixels_coo((0, 720), (0, 720), balance=True),
                    ref.pixels_coo((0, 720), (0, 720), balance=True)):
        assert np.array_equal(a, b, equal_nan=True)
    mine, theirs = load_cool(uri), jload_cool(uri)
    assert (mine[0] != theirs[0]).nnz == 0
    assert mine[1].equals(theirs[1]) and mine[2].equals(theirs[2]) and mine[3] == theirs[3]


# -- the CLI from the fixtures -------------------------------------------- #

def run_cli(args):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        assert main(args, device="cpu") == 0


def cli_args(run, uri, prefix):
    if run == "quantify":
        return ["quantify", "--no-plotting", str(ROOT / "data_test" / "example.bed2"), uri, prefix]
    return ["detect", "--no-plotting", *(["--pattern", "borders"] if run == "borders" else []),
            uri, prefix]


@pytest.fixture(scope="module")
def example_tables(tmp_path_factory):
    """The tables of loops, borders and quantify from data_test/example.cool."""
    workdir = tmp_path_factory.mktemp("example")
    tables = {}
    for run in ("loops", "borders", "quantify"):
        run_cli(cli_args(run, str(EXAMPLE_COOL), str(workdir / run)))
        tables[run] = (workdir / f"{run}.tsv").read_bytes()
    return tables


GOLDENS = {"loops": ("golden_detect_loops", 1e-6), "borders": ("golden_detect_borders", 1e-5),
           "quantify": ("golden_quantify_loops", 1e-6)}
GOLDEN_RUNS = [("loops", "cool"), ("borders", "cool"), ("quantify", "cool"), ("loops", "mcool")]


@pytest.mark.parametrize("run,key", GOLDEN_RUNS, ids=[f"{r}-{k}" for r, k in GOLDEN_RUNS])
def test_goldens_from_fixtures(tmp_path, example_tables, run, key):
    """detect (loops, borders) and quantify (loops) from
    tests/data/example_latest.cool, and detect from
    example_latest.mcool::/resolutions/1000, through the port's CLI on
    the CPU: the goldens' calls, scores within 5e-5 and p-values within
    the goldens' bounds, and each table byte for byte the one from
    data_test/example.cool."""
    prefix = str(tmp_path / "out")
    run_cli(cli_args(run, FIXTURES[key], prefix))
    assert (tmp_path / "out.tsv").read_bytes() == example_tables[run]
    golden, pvalue_tol = GOLDENS[run]
    g = pd.read_csv(DATA / f"{golden}.tsv", sep="\t")
    o = pd.read_csv(prefix + ".tsv", sep="\t")
    key_cols = ["bin1", "bin2"] if run == "quantify" else ["bin1", "bin2", "kernel_id",
                                                           "iteration"]
    o = o.set_index(key_cols).loc[g.set_index(key_cols).index].reset_index()
    assert len(o) == len(g) and o[key_cols].equals(g[key_cols])
    for col, tol in (("score", 5e-5), ("pvalue", pvalue_tol)):
        assert np.array_equal(np.isnan(g[col]), np.isnan(o[col])), col
        assert np.nanmax(np.abs(g[col] - o[col])) < tol, col


def test_norm_force_on_a_weightless_newer_copy(tmp_path):
    """``--norm force`` on example_latest.cool with its weights dropped
    (``File.unlink``) and on a copy of example.cool: the weights written
    into the newer-format file are bit for bit those written into the
    earliest-format one, the tables byte for byte; h5py reads every
    earlier object unchanged and writes to the file again."""
    old, new = tmp_path / "old.cool", tmp_path / "new.cool"
    shutil.copy(EXAMPLE_COOL, old)
    _weightless(LATEST_COOL, new)
    assert CoolSource(str(new)).weights is None
    for path in (old, new):
        run_cli(["detect", "--no-plotting", "--norm", "force", str(path), str(path) + ".out"])
    table = (tmp_path / "old.cool.out.tsv").read_bytes()
    assert (tmp_path / "new.cool.out.tsv").read_bytes() == table
    weights = CoolSource(str(old)).weights
    assert CoolSource(str(new)).weights.tobytes() == weights.tobytes()
    with h5py.File(new, "r") as f, h5py.File(old, "r") as g:
        assert f["bins/weight"][:].tobytes() == weights.tobytes()
        assert_same(dict(f["bins/weight"].attrs), dict(g["bins/weight"].attrs), "stats")
    assert_objects_unchanged(new, h5py_objects(LATEST_COOL), skip=("bins/weight",))
    with h5py.File(new, "r+") as f:
        f["bins"].create_dataset("again", data=np.arange(720))
    assert_reads_like_h5py(new)
