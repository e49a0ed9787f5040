"""The HDF5 features the port's reader (``chromosight_torch.io.hdf5``)
reads beyond the layouts of tests/test_torch_hdf5_formats.py, against
h5py, which is the oracle here and nowhere in the port:

* soft links (symbol-table and link-message forms, absolute and
  relative, to groups and datasets), external links (resolved in the
  linking file's directory; a missing target and a loop raise as in
  h5py), the scale-offset filter on integers (lossless) and floats
  (lossy, held to h5py's read), the n-bit filter on integers and floats
  of fewer significant bits, external storage (raw files named by the
  dataset), and shared object-header messages (in the shared-message
  table's fractal heap, and in a committed datatype's header): each read
  as h5py reads it, natively and under CHROMOSIGHT_TPU_NO_NATIVE;
* the committed fixtures tests/data/example_<feature>.cool (and
  example_external.mcool), each data_test/example.cool written through
  one feature by the functions below: loops, borders and quantify
  through the port's CLI byte for byte the tables from example.cool, and
  ``--norm force`` stores example.cool's 637 finite weights bit for bit.

Rewrite a fixture with ``write_fixture(name)`` (from ``tests/``, with
``PYTHONPATH`` at the repository root).
"""

import contextlib
import ctypes
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from chromosight_torch import native  # noqa: E402
from chromosight_torch.cli.main import main  # noqa: E402
from chromosight_torch.io import hdf5  # noqa: E402
from chromosight_torch.io.source import CoolSource  # noqa: E402
from test_torch_hdf5 import assert_same  # noqa: E402
from test_torch_hdf5_formats import (  # noqa: E402
    COOLER_OPTS,
    assert_reads_like_h5py,
    example_columns,
    write_cooler_group,
)
from torch_parity import torch_one_thread  # noqa: E402, F401

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
EXAMPLE_COOL = ROOT / "data_test" / "example.cool"
LATEST_COOL = DATA / "example_latest.cool"
# H5O_SHMESG_ALL_FLAG: dataspaces, datatypes, fill values, filter
# pipelines and attributes shared
SHMESG_ALL = (1 << 1) | (1 << 3) | (1 << 5) | (1 << 11) | (1 << 12)


# -- the fixtures ---------------------------------------------------------- #

def libhdf5():
    """The HDF5 library h5py runs on (for what h5py does not wrap: the
    shared-message table)."""
    with open("/proc/self/maps") as maps:
        for line in maps:
            path = line.split()[-1]
            if "libhdf5" in path and "_hl" not in os.path.basename(path):
                return ctypes.CDLL(path)
    raise RuntimeError("h5py's libhdf5 is not loaded")


def sohm_file(path):
    """A new h5py file whose every shareable message of at least one byte
    is shared through the superblock extension's shared-message table."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    lib = libhdf5()
    assert lib.H5Pset_shared_mesg_nindexes(ctypes.c_int64(fcpl.id), 1) >= 0
    assert lib.H5Pset_shared_mesg_index(ctypes.c_int64(fcpl.id), 0, SHMESG_ALL, 1) >= 0
    return h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl))


def nbit_dataset(group, name, data, precision):
    """``data`` as ``name`` in a type of ``precision`` significant bits
    (fewer unused bits than a byte, as HDF5 1.14 requires), chunked by
    20,000 rows through the n-bit filter and then gzip."""
    base = h5py.h5t.py_create(data.dtype)
    kind = base.copy()
    kind.set_precision(precision)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk((min(20_000, len(data)),))
    dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0)
    dcpl.set_deflate(6)
    space = h5py.h5s.create_simple(data.shape)
    h5py.h5d.create(group.id, name.encode(), kind, space, dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, np.ascontiguousarray(data))


def _soft(dst):
    """Every table under /data, reached through soft links at the root
    (the groups chroms, bins, pixels and indexes), libver "latest"."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    with h5py.File(dst, "w", libver="latest") as d:
        write_cooler_group(d.create_group("data"), columns, attrs, COOLER_OPTS)
        for key, value in attrs.items():
            d.attrs[key] = value
        for name in ("chroms", "bins", "pixels", "indexes"):
            d[name] = h5py.SoftLink(f"/data/{name}")


def _external(dst):
    """A multi-resolution file whose resolutions/1000 is an external link
    to example_latest.cool in the same directory; resolutions/2000 links
    to a file that is not there."""
    with h5py.File(dst, "w") as d:
        d.attrs["format"] = "HDF5::MCOOL"
        d.attrs["format-version"] = np.int64(2)
        d["resolutions/1000"] = h5py.ExternalLink(LATEST_COOL.name, "/")
        d["resolutions/2000"] = h5py.ExternalLink("example_missing.cool", "/")


def _scaleoffset(dst):
    """The integer columns (pixels, bins, indexes) through the
    scale-offset filter (lossless on integers) and then gzip."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    with h5py.File(dst, "w") as d:
        for key, value in attrs.items():
            d.attrs[key] = value
        for name, value in columns.items():
            if value.dtype.kind in "iu":
                d.create_dataset(name, data=value, chunks=(min(20_000, len(value)),),
                                 scaleoffset=0, compression="gzip")
            else:
                d.create_dataset(name, data=value, **COOLER_OPTS)


def _nbit(dst):
    """The pixel columns and bins start and end in types of fewer
    significant bits (57 of the int64 ids, 25 of the int32 counts and
    bins) through the n-bit filter and then gzip."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    with h5py.File(dst, "w") as d:
        for key, value in attrs.items():
            d.attrs[key] = value
        for name, value in columns.items():
            group, _, leaf = name.rpartition("/")
            if name.startswith("pixels/") or name in ("bins/start", "bins/end"):
                nbit_dataset(d.require_group(group), leaf, value,
                             57 if value.dtype.itemsize == 8 else 25)
            else:
                d.create_dataset(name, data=value)


def _external_storage(dst):
    """The chroms, bins and indexes tables in one raw file beside the
    .cool (external storage, each dataset a slot of it), the pixels
    chunked with gzip inside it."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    raw = dst.with_suffix(".raw")
    with contextlib.chdir(dst.parent), h5py.File(dst, "w") as d:
        for key, value in attrs.items():
            d.attrs[key] = value
        offset = 0
        for name, value in columns.items():
            if name.startswith("pixels/"):
                d.create_dataset(name, data=value, chunks=(20_000,), **COOLER_OPTS)
                continue
            d.create_dataset(name, data=value, external=[(raw.name, offset, value.nbytes)])
            offset += value.nbytes
    return raw


def _shared(dst):
    """Every dataspace, datatype, fill value, filter pipeline and attribute
    shared through the shared-message table (messages in its fractal
    heap), and the pixel ids' datatype a committed one (/types/id: a
    shared message in its header)."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    with sohm_file(dst) as d:
        d["types/id"] = np.dtype("<i8")
        for key, value in attrs.items():
            d.attrs[key] = value
        for name, value in columns.items():
            kind = d["types/id"] if name in ("pixels/bin1_id", "pixels/bin2_id") else None
            d.create_dataset(name, data=value, dtype=kind,
                             chunks=(min(20_000, len(value)),), **COOLER_OPTS)
            d[name].attrs["column"] = name


def _dense_bins(dst):
    """libver "latest" with five more bins columns (normalisation vectors
    KR, VC, VC_SQRT, GW_KR, GW_VC): nine links, a dense bins group."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    rng = np.random.RandomState(0)
    with h5py.File(dst, "w", libver="latest") as d:
        write_cooler_group(d, columns, attrs, COOLER_OPTS)
        for name in ("KR", "VC", "VC_SQRT", "GW_KR", "GW_VC"):
            d.create_dataset(f"bins/{name}", data=rng.rand(720), **COOLER_OPTS)


# szip with h5py's options ('nn' or 'ec', pixels per block) on every
# dataset HDF5 takes szip for; the rest (fixed strings, columns of fewer
# rows than a block) with cooler's gzip 6 + shuffle
SZIP_NN = dict(compression="szip", compression_opts=("nn", 16))
SZIP_SHUFFLE_EC = dict(compression="szip", compression_opts=("ec", 8), shuffle=True)
SZIP_SHUFFLE_NN = dict(compression="szip", compression_opts=("nn", 8), shuffle=True)
PIXEL_CHUNK = 20_000


def _szip_example(dst, opts, ids=None, big_endian=()):
    """The example's tables chunked (pixel columns by ``PIXEL_CHUNK``
    rows, the others whole) with szip ``opts`` (the pixel ids with
    ``ids`` when given) where HDF5 takes them, the columns named in
    ``big_endian`` stored big-endian."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    with h5py.File(dst, "w") as d:
        for key, value in attrs.items():
            d.attrs[key] = value
        for name, value in columns.items():
            if name in big_endian:
                value = value.astype(value.dtype.newbyteorder(">"))
            chunk = (min(PIXEL_CHUNK, len(value)),)
            szip = (ids if ids and name in ("pixels/bin1_id", "pixels/bin2_id") else opts)
            if value.dtype.kind not in "iuf" or chunk[0] < szip["compression_opts"][1]:
                szip = COOLER_OPTS
            d.create_dataset(name, data=value, chunks=chunk, **szip)


def _szip(dst):
    """szip NN in blocks of 16 pixels (the int64 ids as 64-bit pixels)."""
    _szip_example(dst, SZIP_NN)


def _szip_shuffle_ec(dst):
    """shuffle + szip: EC in blocks of 8 pixels, the counts big-endian;
    the pixel ids h5py's default NN in blocks of 8 (EC would double
    them)."""
    _szip_example(dst, SZIP_SHUFFLE_EC, ids=SZIP_SHUFFLE_NN, big_endian=("pixels/count",))


def _virtual(dst):
    """The pixel columns virtual datasets over two files beside it,
    example_virtual_a.h5 (the first chromosome's pixel rows) and
    example_virtual_b.h5 (the rest), and bins/end one over
    /sources/bins_end of the same file ("."); libver "latest"."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    first = int(np.sum(columns["bins/chrom"] == 0))
    split = int(columns["indexes/bin1_offset"][first])
    nnz = len(columns["pixels/count"])
    parts = {"a": (0, split), "b": (split, nnz)}
    for part, (lo, hi) in parts.items():
        with h5py.File(dst.parent / f"example_virtual_{part}.h5", "w") as s:
            for col in ("bin1_id", "bin2_id", "count"):
                s.create_dataset(f"pixels/{col}", data=columns[f"pixels/{col}"][lo:hi],
                                 chunks=(min(PIXEL_CHUNK, hi - lo),), **COOLER_OPTS)
    with h5py.File(dst, "w", libver="latest") as d:
        for key, value in attrs.items():
            d.attrs[key] = value
        for name, value in columns.items():
            if name.startswith("pixels/"):
                layout = h5py.VirtualLayout(shape=value.shape, dtype=value.dtype)
                for part, (lo, hi) in parts.items():
                    layout[lo:hi] = h5py.VirtualSource(f"example_virtual_{part}.h5", name,
                                                       shape=(hi - lo,))
                d.create_virtual_dataset(name, layout)
            elif name == "bins/end":
                d.create_dataset("sources/bins_end", data=value)
                layout = h5py.VirtualLayout(shape=value.shape, dtype=value.dtype)
                layout[:] = h5py.VirtualSource(".", "sources/bins_end", shape=value.shape)
                d.create_virtual_dataset(name, layout)
            else:
                d.create_dataset(name, data=value)


# the example's pixel rows in each source file of the printf-style
# virtual fixture: three blocks, the last two rows short (read as the
# fill value, 0, past the third file's end)
PRINTF_BLOCK = 36_659


def _virtual_printf(dst):
    """The pixel columns virtual datasets of one unlimited printf-style
    mapping each (``%b``, the block number): blocks of ``PRINTF_BLOCK``
    rows from example_virtual_printf_0.h5 .. _2.h5 beside it, their
    extent set by the files there are; the other datasets in the file;
    libver "latest"."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    nnz = len(columns["pixels/count"])
    for k in range(-(-nnz // PRINTF_BLOCK)):
        rows = slice(k * PRINTF_BLOCK, (k + 1) * PRINTF_BLOCK)
        with h5py.File(dst.parent / f"example_virtual_printf_{k}.h5", "w") as s:
            for col in ("bin1_id", "bin2_id", "count"):
                value = columns[f"pixels/{col}"][rows]
                s.create_dataset(f"pixels/{col}", data=value, chunks=(min(PIXEL_CHUNK,
                                                                          len(value)),),
                                 **COOLER_OPTS)
    unlimited = h5py.h5s.UNLIMITED
    with h5py.File(dst, "w", libver="latest") as d:
        for key, value in attrs.items():
            d.attrs[key] = value
        for name, value in columns.items():
            if not name.startswith("pixels/"):
                d.create_dataset(name, data=value)
                continue
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            virtual = h5py.h5s.create_simple((0,), (unlimited,))
            virtual.select_hyperslab((0,), (unlimited,), stride=(PRINTF_BLOCK,),
                                     block=(PRINTF_BLOCK,))
            dcpl.set_virtual(virtual, b"example_virtual_printf_%b.h5", name.encode(),
                             h5py.h5s.create_simple((PRINTF_BLOCK,)))
            d.require_group("pixels")
            h5py.h5d.create(d.id, name.encode(), h5py.h5t.py_create(value.dtype),
                            h5py.h5s.create_simple((0,), (unlimited,)), dcpl=dcpl)


# the text a tool that prepends a header to a .cool puts in its user block
USERBLOCK_TEXT = b"# data_test/example.cool, with this header in an HDF5 user block\n"


def _userblock(dst, userblock, sizes, libver):
    """The example in cooler's layout (``write_cooler_group``) after a user
    block of ``userblock`` bytes that starts with ``USERBLOCK_TEXT``, with
    offsets and lengths of ``sizes`` bytes, at h5py's ``libver``
    ("earliest": superblock 0, symbol-table groups; "latest": superblock
    3, new-style groups, layout 4)."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_userblock(userblock)
    fcpl.set_sizes(*sizes)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    low = h5py.h5f.LIBVER_LATEST if libver == "latest" else h5py.h5f.LIBVER_EARLIEST
    fapl.set_libver_bounds(low, h5py.h5f.LIBVER_LATEST)
    fid = h5py.h5f.create(str(dst).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl)
    with h5py.File(fid) as f:
        write_cooler_group(f, columns, attrs, COOLER_OPTS)
    with open(dst, "r+b") as handle:
        handle.write(USERBLOCK_TEXT)


def userblock_fixture(userblock, sizes, libver):
    return lambda dst: _userblock(dst, userblock, sizes, libver)


# (user block, sizes of offsets and lengths, libver) of the user-block
# fixtures.  HDF5 1.14 opens no unlimited dataset of layout 4 with
# lengths of fewer than 8 bytes, so the 4-byte ones are at "earliest";
# 2-byte offsets address 64 KiB, less than the example takes.
USERBLOCKS = {
    "userblock_512_44": (512, (4, 4), "earliest"),
    "userblock_4096_44": (4096, (4, 4), "earliest"),
    "userblock_512_88": (512, (8, 8), "latest"),
    "userblock_4096_88": (4096, (8, 8), "earliest"),
    "userblock_4096_48": (4096, (4, 8), "latest"),
}

FIXTURES = {
    **{name: (userblock_fixture(*how), f"example_{name}.cool", "")
       for name, how in USERBLOCKS.items()},
    "soft": (_soft, "example_soft.cool", ""),
    "external": (_external, "example_external.mcool", "::/resolutions/1000"),
    "scaleoffset": (_scaleoffset, "example_scaleoffset.cool", ""),
    "nbit": (_nbit, "example_nbit.cool", ""),
    "external_storage": (_external_storage, "example_external_storage.cool", ""),
    "shared": (_shared, "example_shared.cool", ""),
    "dense_bins": (_dense_bins, "example_dense_bins.cool", ""),
    "szip": (_szip, "example_szip.cool", ""),
    "szip_shuffle_ec": (_szip_shuffle_ec, "example_szip_shuffle_ec.cool", ""),
    "virtual": (_virtual, "example_virtual.cool", ""),
    "virtual_printf": (_virtual_printf, "example_virtual_printf.cool", ""),
}
# the files a fixture reads besides itself
FIXTURE_FILES = {
    "external": (LATEST_COOL.name,),
    "external_storage": ("example_external_storage.raw",),
    "virtual": ("example_virtual_a.h5", "example_virtual_b.h5"),
    "virtual_printf": tuple(f"example_virtual_printf_{k}.h5" for k in range(3)),
}
# columns a fixture stores big-endian (read as h5py reads them: in that
# byte order)
BIG_ENDIAN = {"szip_shuffle_ec": ("pixels/count",)}


def write_fixture(name, directory=DATA):
    """Write the fixture ``name`` of ``FIXTURES`` into ``directory``; its
    path."""
    make, filename, _ = FIXTURES[name]
    dst = pathlib.Path(directory) / filename
    make(dst)
    return dst


def stored_columns(name):
    """{path: array} of example.cool's datasets as fixture ``name`` stores
    them (``BIG_ENDIAN`` columns big-endian; the printf-style fixture's
    pixel columns followed by the fill value up to whole blocks)."""
    columns, _ = example_columns(EXAMPLE_COOL)
    out = {key: value.astype(value.dtype.newbyteorder(">"))
           if key in BIG_ENDIAN.get(name, ()) else value for key, value in columns.items()}
    if name == "virtual_printf":
        for key in [k for k in out if k.startswith("pixels/")]:
            pad = -len(out[key]) % PRINTF_BLOCK
            out[key] = np.concatenate([out[key], np.zeros(pad, out[key].dtype)])
    return out


def fixture_uri(name, directory=DATA):
    _, filename, group = FIXTURES[name]
    return f"{pathlib.Path(directory) / filename}{group}"


def copy_fixture(name, directory):
    """The fixture with the files it reads (an external link's target,
    external storage's raw file) copied into ``directory``; its URI."""
    _, filename, _ = FIXTURES[name]
    for other in (filename, *FIXTURE_FILES.get(name, ())):
        shutil.copy(DATA / other, directory)
    return fixture_uri(name, directory)


# -- each feature read as h5py reads it ------------------------------------ #

def _feature_soft(path, rng):
    with h5py.File(path, "w") as f:  # symbol-table groups: soft links in the heap
        f["real/y"] = rng.rand(7)
        f["abs"] = h5py.SoftLink("/real/y")
        f["real/rel"] = h5py.SoftLink("y")
        f["group"] = h5py.SoftLink("/real")
    return ["abs", "real/rel", "group/y"]


def _feature_soft_latest(path, rng):
    with h5py.File(path, "w", libver="latest") as f:  # link messages of type 1
        f["real/y"] = rng.randint(0, 9, 7)
        f["abs"] = h5py.SoftLink("/real/y")
        f["real/rel"] = h5py.SoftLink("./y")
        f["group"] = h5py.SoftLink("/real")
    return ["abs", "real/rel", "group/y"]


def _feature_external(path, rng):
    target = path.parent / "target.h5"
    with h5py.File(target, "w") as f:
        f["data/x"] = rng.rand(9)
        f["back"] = h5py.ExternalLink(path.name, "/local")
    with h5py.File(path, "w", libver="latest") as f:
        f["local"] = np.arange(3)
        f["ext"] = h5py.ExternalLink(target.name, "/data")
        f["round"] = h5py.ExternalLink(target.name, "/back")
    return ["ext/x", "round"]


def _feature_scaleoffset_int(path, rng):
    with h5py.File(path, "w") as f:
        f.create_dataset("i4", data=rng.randint(-500, 9000, 5000).astype(np.int32),
                         chunks=(700,), scaleoffset=0)
        f.create_dataset("i8", data=rng.randint(0, 720, 5000), chunks=(700,), scaleoffset=0,
                         compression="gzip")
        f.create_dataset("be", data=rng.randint(0, 999, 5000).astype(">i4"), chunks=(700,),
                         scaleoffset=0)
        f.create_dataset("fill", data=rng.randint(0, 90, 5000).astype(np.int32),
                         chunks=(700,), scaleoffset=0, fillvalue=-7)
        f.create_dataset("constant", data=np.full(900, 42, np.int32), chunks=(700,),
                         scaleoffset=0)
    return ["i4", "i8", "be", "fill", "constant"]


def _feature_scaleoffset_float(path, rng):
    with h5py.File(path, "w") as f:
        f.create_dataset("f4", data=(rng.rand(5000) * 100).astype(np.float32), chunks=(700,),
                         scaleoffset=3)
        f.create_dataset("f8", data=rng.randn(5000) * 1e3, chunks=(700,), scaleoffset=2)
    return ["f4", "f8"]


def _feature_nbit(path, rng):
    with h5py.File(path, "w") as f:
        for name, base, precision, offset, data in (
                ("i4", h5py.h5t.STD_I32LE, 25, 0, rng.randint(-3000, 3000, 5000)),
                ("u8", h5py.h5t.STD_U64LE, 57, 5, rng.randint(0, 8000, 5000)),
                ("i2be", h5py.h5t.STD_I16BE, 11, 3, rng.randint(-900, 900, 5000))):
            kind = base.copy()
            kind.set_precision(precision)
            kind.set_offset(offset)
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((700,))
            dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0)
            h5py.h5d.create(f.id, name.encode(), kind, h5py.h5s.create_simple((5000,)),
                            dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL,
                                             np.asarray(data, kind.dtype))
        # a float64 of 45 mantissa bits, its fields below a 7-bit offset
        kind = h5py.h5t.IEEE_F64LE.copy()
        kind.set_fields(56, 45, 11, 0, 45)
        kind.set_precision(57)
        kind.set_offset(7)
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((700,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT, 0)
        h5py.h5d.create(f.id, b"f8", kind, h5py.h5s.create_simple((5000,)), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, rng.randn(5000))
    return ["i4", "u8", "i2be", "f8"]


def _feature_external_storage(path, rng):
    with contextlib.chdir(path.parent), h5py.File(path, "w") as f:
        f.create_dataset("two_files", data=rng.randint(0, 99, 100),
                         external=[("a.raw", 0, 400), ("b.raw", 16, h5py.h5f.UNLIMITED)])
        f.create_dataset("floats", data=rng.rand(3, 5), external=[("c.raw", 8, 120)])
    return ["two_files", "floats"]


def _feature_shared(path, rng):
    with sohm_file(path) as f:
        f["types/id"] = np.dtype("<i8")
        f.create_dataset("committed", data=rng.randint(0, 9, 20), dtype=f["types/id"])
        for i in range(3):
            d = f.create_dataset(f"s{i}", data=rng.rand(30), chunks=(10,), **COOLER_OPTS)
            d.attrs["unit"] = "bp"
            d.attrs["k"] = i
        f.attrs["x"] = 3
    return ["committed", "s0", "s1", "s2"]


FEATURES = {
    "soft_link": (_feature_soft, {"soft link": 3}),
    "soft_link_latest": (_feature_soft_latest, {"soft link": 3}),
    "external_link": (_feature_external, {"external link": 2, "external file": 1}),
    "scaleoffset_int": (_feature_scaleoffset_int, {"scale-offset chunk": 30}),
    "scaleoffset_float": (_feature_scaleoffset_float, {"scale-offset chunk": 14}),
    "nbit": (_feature_nbit, {"n-bit chunk": 28}),
    "external_storage": (_feature_external_storage, {"external storage": 2}),
    "shared_messages": (_feature_shared, {"SMTB": 1, "shared message in a heap": 1,
                                          "shared message": 1}),
}


def read_like_h5py(path, names):
    """Each of ``names`` read by the port as h5py reads it (whole and in
    slices across chunks; attributes); the structures walked."""
    with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
        for name in names:
            mine, theirs = ours[name], ref[name]
            assert list(mine.attrs) == list(theirs.attrs), name
            for key in theirs.attrs:
                assert_same(mine.attrs[key], theirs.attrs[key], f"{name}@{key}")
            if isinstance(theirs, h5py.Group):
                assert list(mine.keys()) == list(theirs), name
                continue
            assert mine.dtype == theirs.dtype and mine.shape == theirs.shape, name
            assert mine[()].tobytes() == theirs[()].tobytes(), name
            n = theirs.shape[0]
            for lo, hi in ((1, n - 1), (699, 701), (n // 3, n // 2)):
                assert mine[lo:hi].tobytes() == theirs[lo:hi].tobytes(), (name, lo, hi)
        return ours.walked


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_feature_reads_like_h5py(tmp_path, monkeypatch, feature):
    """Each feature's datasets (and groups) read by the port as h5py reads
    them, the reader walking the feature's structures, and every object
    h5py visits read as h5py reads it."""
    monkeypatch.chdir(tmp_path)  # h5py finds external storage from here
    make, expect = FEATURES[feature]
    path = tmp_path / "feature.h5"
    names = make(path, np.random.RandomState(len(feature)))
    walked = read_like_h5py(path, names)
    for key, count in expect.items():
        assert walked[key] >= count, (key, dict(walked))
    assert_reads_like_h5py(path)


def test_missing_external_target_and_link_loops(tmp_path):
    """An external link to a file that is not there raises KeyError, and
    a loop of links RuntimeError past HDF5's 16, as h5py raises them;
    ``in`` says False for both."""
    path = tmp_path / "links.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f["missing"] = h5py.ExternalLink("not_there.h5", "/x")
        f["dangling"] = h5py.SoftLink("/nothing")
        f["a"] = h5py.SoftLink("/b")
        f["b"] = h5py.SoftLink("/a")
    with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
        for name, error in (("missing", KeyError), ("dangling", KeyError), ("a", RuntimeError)):
            with pytest.raises(error):
                ref[name]
            with pytest.raises(error):
                ours[name]
            assert name not in ours and list(ours.root.keys()) == list(ref)


NO_NATIVE_READ = """
import json, sys
from chromosight_torch import native
from chromosight_torch.io import hdf5
assert not native.filters_native() and native.get_lib() is None
out = {}
with hdf5.File(sys.argv[1]) as f:
    for name in sys.argv[2:]:
        out[name] = f[name][()].tobytes().hex()
print(json.dumps(out))
"""


@pytest.mark.parametrize("feature", ["scaleoffset_int", "scaleoffset_float", "nbit"])
def test_native_decoders_equal_numpy(tmp_path, feature):
    """``bits.cpp``'s n-bit and scale-offset decoders give the bytes of
    their numpy versions: the native read here against a subprocess under
    CHROMOSIGHT_TPU_NO_NATIVE=1; and the two entries on every chunk of
    the datasets with no other filter."""
    make, _ = FEATURES[feature]
    path = tmp_path / "feature.h5"
    names = make(path, np.random.RandomState(5))
    env = dict(os.environ, CHROMOSIGHT_TPU_NO_NATIVE="1", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", NO_NATIVE_READ, str(path), *names], env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    got = json.loads(out.stdout)
    assert native.filters_native()
    with hdf5.File(path) as f:
        for name in names:
            assert f[name][()].tobytes().hex() == got[name], name
            d = f[name]
            if len(d._filters) > 1:
                continue  # a later filter (gzip) first: the whole read above holds it
            _, addrs, sizes, masks = d._chunk_index()
            for addr, size in zip(addrs, sizes):
                raw = f._read(int(addr), int(size))
                fid, values = d._filters[0]
                if fid == hdf5.NBIT:
                    assert native.nbit_decode(raw, values) == native.nbit_decode_numpy(raw,
                                                                                       values)
                else:
                    assert native.scaleoffset_decode(raw, values) == \
                        native.scaleoffset_decode_numpy(raw, values)


# -- the committed fixtures ------------------------------------------------ #

def test_fixtures_hold_the_example(tmp_path, monkeypatch):
    """Each fixture holds data_test/example.cool's tables and attributes
    through h5py, and its writer writes it again with the same contents."""
    monkeypatch.chdir(DATA)  # h5py opens external storage from here
    _, attrs = example_columns(EXAMPLE_COOL)
    for name in sorted(FIXTURES):
        path, _, group = fixture_uri(name).partition("::")
        stored = stored_columns(name)
        with h5py.File(path, "r") as f:
            g = f[group or "/"]
            assert_same(dict(g.attrs), attrs, name)
            for key, value in stored.items():
                assert g[key][()].tobytes() == value.tobytes(), (name, key)
                assert g[key].dtype == value.dtype, (name, key)
        assert os.path.getsize(path) < 400_000, name
        again = copy_fixture(name, tmp_path)
        write_fixture(name, tmp_path)
        with h5py.File(again.partition("::")[0], "r") as f:
            g = f[group or "/"]
            for key, value in stored.items():
                assert g[key][()].tobytes() == value.tobytes(), (name, key)
    with h5py.File(fixture_uri("dense_bins"), "r") as f:
        assert len(f["bins"]) == 9


def run_cli(args):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        assert main(args, device="cpu") == 0


def cli_args(run, uri, prefix, flags=()):
    if run == "quantify":
        return ["quantify", "--no-plotting", *flags, str(ROOT / "data_test" / "example.bed2"),
                uri, prefix]
    return ["detect", "--no-plotting", *flags,
            *(["--pattern", "borders"] if run == "borders" else []), uri, prefix]


@pytest.fixture(scope="module")
def example_tables(tmp_path_factory):
    """The tables of loops, borders and quantify from data_test/example.cool."""
    workdir = tmp_path_factory.mktemp("example")
    tables = {}
    for run in ("loops", "borders", "quantify"):
        run_cli(cli_args(run, str(EXAMPLE_COOL), str(workdir / run)))
        tables[run] = (workdir / f"{run}.tsv").read_bytes()
    return tables


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_goldens_from_fixtures(tmp_path, example_tables, name):
    """detect (loops, borders) and quantify (loops) from each fixture
    through the port's CLI on the CPU: each table byte for byte the one
    from data_test/example.cool (whose loops are the 89 of
    tests/data/golden_detect_loops.tsv)."""
    uri = fixture_uri(name)
    for run in ("loops", "borders", "quantify"):
        prefix = str(tmp_path / run)
        run_cli(cli_args(run, uri, prefix))
        assert (tmp_path / f"{run}.tsv").read_bytes() == example_tables[run], run


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_norm_force_on_fixtures(tmp_path, name):
    """``--norm force`` on a copy of each fixture (and of the files it
    reads) and on a copy of example.cool: the 637 finite weights stored
    bit for bit alike, the tables byte for byte; h5py reads the new
    weights and every earlier dataset unchanged."""
    old = tmp_path / "old.cool"
    shutil.copy(EXAMPLE_COOL, old)
    (tmp_path / "copy").mkdir()
    uri = copy_fixture(name, tmp_path / "copy")
    for src, prefix in ((str(old), tmp_path / "old"), (uri, tmp_path / "new")):
        run_cli(cli_args("loops", src, str(prefix), ["--norm", "force"]))
    assert (tmp_path / "new.tsv").read_bytes() == (tmp_path / "old.tsv").read_bytes()
    weights = CoolSource(str(old)).weights
    assert np.isfinite(weights).sum() == 637
    assert CoolSource(uri).weights.tobytes() == weights.tobytes()
    path, _, group = uri.partition("::")
    with contextlib.chdir(tmp_path / "copy"), h5py.File(path, "r") as f:
        g = f[group or "/"]
        assert g["bins/weight"][()].tobytes() == weights.tobytes()
        for key, value in stored_columns(name).items():
            if key != "bins/weight":
                assert g[key][()].tobytes() == value.tobytes(), key
