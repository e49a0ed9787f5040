"""HDF5's virtual datasets (data layout class 3) in the port's HDF5 reader
(``chromosight_torch.io.hdf5``), against h5py, which writes them
(``VirtualLayout`` / ``VirtualSource``) and is the oracle here and nowhere
in the port:

* mappings to sources in the same file ("."), in a sibling file (found
  from the virtual file's directory), in a file or dataset that is not
  there (the fill value), gaps no mapping covers (the fill value), strided
  selections, two-dimensional rows, a source of another type, a virtual
  source, selections of HDF5's versions 1 (libver "earliest") and 3
  ("latest"): read as h5py reads them, whole and in slices across the
  mappings' edges;
* unlimited mappings, resolved as HDF5 resolves them on open: a
  printf-style source name (``%b``, the block number; ``%%``) over three
  and four source files, the extent following the files there are; a
  source that grows after the virtual file was written; a missing block
  file, whose block and those after it read as the fill value; unlimited
  counts of blocks with gaps and an unlimited block;
* the mappings' lookup3 checksum is checked: a flipped byte raises;
* what stays outside the subset raises NotImplementedError naming it and
  its file offset: unlimited selections along an inner axis (with a
  printf-style name or not), selections of part of an inner axis,
  mappings deeper than ``LINK_DEPTH``;
* source files are opened with the virtual file's mode and closed with
  it;
* the JAX package's CLI (h5py reading tests/data/example_virtual.cool)
  against the port's on the CPU.
"""

import os
import pathlib

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from chromosight_torch.io import hdf5  # noqa: E402
from chromosight_torch.io import hdf5_index  # noqa: E402
from test_torch_hdf5_formats import assert_reads_like_h5py  # noqa: E402
from test_torch_cooler_layout import RUNS, assert_jax_calls  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402, F401

ROOT = pathlib.Path(__file__).parents[1]
VIRTUAL_COOL = ROOT / "tests" / "data" / "example_virtual.cool"


def _sources(directory, rng):
    """A sibling file of sources: x (int64, 300 rows), y (big-endian
    int32, 100 rows), m (7 x 3 floats)."""
    with h5py.File(directory / "sources.h5", "w") as f:
        f.create_dataset("x", data=rng.randint(0, 1 << 40, 300), chunks=(64,),
                         compression="gzip", shuffle=True)
        f["y"] = rng.randint(-999, 999, 100).astype(">i4")
        f["m"] = rng.rand(7, 3)
    return "sources.h5"


def _same_file(path, rng, libver):
    with h5py.File(path, "w", libver=libver) as f:
        f["data/a"] = rng.randint(0, 99, 40)
        f.create_dataset("data/b", data=rng.randint(0, 99, 50), chunks=(8,), compression="gzip")
        layout = h5py.VirtualLayout(shape=(120,), dtype="i8")
        layout[0:40] = h5py.VirtualSource(".", "data/a", shape=(40,))
        layout[60:90] = h5py.VirtualSource(".", "data/b", shape=(50,))[10:40]
        f.create_virtual_dataset("v", layout, fillvalue=-7)
    return ["v"]


def _sibling(path, rng, libver):
    name = _sources(path.parent, rng)
    with h5py.File(path, "w", libver=libver) as f:
        layout = h5py.VirtualLayout(shape=(500,), dtype="i8")
        layout[0:250] = h5py.VirtualSource(name, "x", shape=(300,))[50:300]
        layout[250:500] = h5py.VirtualSource(name, "x", shape=(300,))[0:250]
        f.create_virtual_dataset("v", layout)
        layout = h5py.VirtualLayout(shape=(100,), dtype="<i8")  # another type
        layout[:] = h5py.VirtualSource(name, "y", shape=(100,))
        f.create_virtual_dataset("converted", layout)
    return ["v", "converted"]


def _missing(path, rng, libver):
    name = _sources(path.parent, rng)
    with h5py.File(path, "w", libver=libver) as f:
        layout = h5py.VirtualLayout(shape=(90,), dtype="i8")
        layout[0:30] = h5py.VirtualSource("not_there.h5", "x", shape=(30,))
        layout[30:60] = h5py.VirtualSource(name, "no_such_dataset", shape=(30,))
        layout[60:90] = h5py.VirtualSource(name, "x", shape=(300,))[0:30]
        f.create_virtual_dataset("v", layout, fillvalue=5)
    return ["v"]


def _strided(path, rng, libver):
    name = _sources(path.parent, rng)
    with h5py.File(path, "w", libver=libver) as f:
        layout = h5py.VirtualLayout(shape=(200,), dtype="i8")
        layout[0:100:2] = h5py.VirtualSource(name, "x", shape=(300,))[0:150:3]
        layout[101:200:7] = h5py.VirtualSource(name, "x", shape=(300,))[200:215]
        f.create_virtual_dataset("v", layout, fillvalue=-1)
    return ["v"]


def _two_d(path, rng, libver):
    name = _sources(path.parent, rng)
    with h5py.File(path, "w", libver=libver) as f:
        layout = h5py.VirtualLayout(shape=(20, 3), dtype="f8")
        layout[2:9] = h5py.VirtualSource(name, "m", shape=(7, 3))
        layout[12:16] = h5py.VirtualSource(name, "m", shape=(7, 3))[1:5]
        f.create_virtual_dataset("v", layout, fillvalue=0.5)
    return ["v"]


def _chained(path, rng, libver):
    name = _sources(path.parent, rng)
    with h5py.File(path.parent / "middle.h5", "w", libver=libver) as f:
        layout = h5py.VirtualLayout(shape=(300,), dtype="i8")
        layout[:] = h5py.VirtualSource(name, "x", shape=(300,))
        f.create_virtual_dataset("mid", layout)
    with h5py.File(path, "w", libver=libver) as f:
        layout = h5py.VirtualLayout(shape=(100,), dtype="i8")
        layout[10:90] = h5py.VirtualSource("middle.h5", "mid", shape=(300,))[100:180]
        f.create_virtual_dataset("v", layout, fillvalue=2)
    return ["v"]


CASES = {"same_file": _same_file, "sibling": _sibling, "missing": _missing,
         "strided": _strided, "two_d": _two_d, "chained": _chained}


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_virtual_reads_like_h5py(tmp_path, monkeypatch, case, libver):
    """Each case's virtual datasets read as h5py reads them (dtype, shape,
    whole, and slices across every mapping's edges), the reader counting
    the mappings it read; every object h5py visits reads alike."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "virtual.h5"
    names = CASES[case](path, np.random.RandomState(len(case)), libver)
    with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
        for name in names:
            theirs, mine = ref[name], ours[name]
            assert theirs.is_virtual
            assert mine.dtype == theirs.dtype and mine.shape == theirs.shape, name
            assert mine[()].tobytes() == theirs[()].tobytes(), name
            n = theirs.shape[0]
            edges = sorted({0, n, *(e for m in theirs.virtual_sources()
                                    for e in m.vspace.get_select_bounds()[0][:1]),
                            *(e + 1 for m in theirs.virtual_sources()
                              for e in m.vspace.get_select_bounds()[1][:1])})
            for edge in edges:
                for lo, hi in ((edge - 1, edge + 1), (edge - 3, edge + 17), (edge, edge)):
                    lo, hi = max(lo, 0), min(hi, n)
                    assert mine[lo:hi].tobytes() == theirs[lo:hi].tobytes(), (name, lo, hi)
        assert ours.walked["virtual mapping"] > 0
    assert_reads_like_h5py(path)


def heap_object(path, name):
    """(offset in the file, bytes) of the global heap object holding
    ``name``'s mappings."""
    with hdf5.File(path) as f:
        addr, at = f[name]._vds
        block = f._global_heap(addr)[at]
    raw = pathlib.Path(path).read_bytes()
    return raw.index(block), block


def test_mappings_checksum_checked(tmp_path):
    """The mappings' stored lookup3 checksum matches what the reader
    computes, and a byte flipped inside them raises OSError (h5py raises
    too)."""
    path = tmp_path / "virtual.h5"
    _same_file(path, np.random.RandomState(0), "latest")
    offset, block = heap_object(path, "v")
    assert hdf5_index.lookup3(block[:-4]) == int.from_bytes(block[-4:], "little")
    raw = bytearray(path.read_bytes())
    raw[offset + 12] ^= 0x40
    path.write_bytes(bytes(raw))
    with hdf5.File(path) as f, pytest.raises(OSError, match="checksum"):
        f["v"][:]
    with h5py.File(path, "r") as f, pytest.raises(Exception):
        f["v"][:]


def _inner_unlimited(path, name):
    """A 2-D virtual dataset unlimited along its second axis, mapped from
    ``name`` (a printf-style one or not) by an unlimited selection there."""
    with h5py.File(path.parent / "src_0.h5", "w") as f:
        f.create_dataset("x", data=np.arange(8).reshape(2, 4), maxshape=(2, None), chunks=(2, 2))
    unlimited = h5py.h5s.UNLIMITED
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    virtual = h5py.h5s.create_simple((2, 4), (2, unlimited))
    virtual.select_hyperslab((0, 0), (1, unlimited), stride=(1, 4), block=(2, 4))
    source = h5py.h5s.create_simple((2, 4), (2, unlimited))
    source.select_hyperslab((0, 0), (1, 1), block=(2, 4))
    if b"%b" not in name:
        source.select_hyperslab((0, 0), (1, unlimited), stride=(1, 4), block=(2, 4))
    dcpl.set_virtual(virtual, name, b"x", source)
    with h5py.File(path, "w", libver="latest") as f:
        h5py.h5d.create(f.id, b"v", h5py.h5t.STD_I64LE, h5py.h5s.create_simple(
            (2, 4), (2, unlimited)), dcpl=dcpl)
    return "unlimited virtual dataset selection along an inner axis"


def _unlimited(path):
    return _inner_unlimited(path, b"src_0.h5")


def _printf(path):
    return _inner_unlimited(path, b"src_%b.h5")


def _inner_axis(path):
    with h5py.File(path.parent / "src.h5", "w") as f:
        f["x"] = np.arange(20).reshape(10, 2)
    layout = h5py.VirtualLayout(shape=(10, 4), dtype="i8")
    layout[:, 0:2] = h5py.VirtualSource("src.h5", "x", shape=(10, 2))
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("v", layout)
    return "part of an inner axis"


def _loop(path):
    """A virtual dataset mapped onto itself (h5py itself does not return
    from reading it)."""
    layout = h5py.VirtualLayout(shape=(5,), dtype="i8")
    layout[:] = h5py.VirtualSource(".", "v", shape=(5,))
    with h5py.File(path, "w") as f:
        f.create_virtual_dataset("v", layout, fillvalue=3)
    return "deeper than 16"


@pytest.mark.parametrize("make", [_unlimited, _printf, _inner_axis, _loop],
                         ids=["unlimited", "printf", "inner_axis", "loop"])
def test_outside_the_subset_raises(tmp_path, monkeypatch, make):
    """What the reader does not read raises NotImplementedError naming the
    feature and its file offset, never a wrong read."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "virtual.h5"
    what = make(path)
    with hdf5.File(path) as f, pytest.raises(NotImplementedError,
                                             match=f"{what}.* at file offset"):
        f["v"][:]


# -- unlimited mappings ---------------------------------------------------- #

UNLIMITED = h5py.h5s.UNLIMITED
BLOCK = 6


def _block_files(directory, n, pattern="src_{}.h5", dataset="x", skip=()):
    """``n`` source files of ``BLOCK`` rows each (block k's rows 100 k +
    0..5), but those in ``skip``."""
    for k in range(n):
        if k not in skip:
            with h5py.File(directory / pattern.format(k), "w") as f:
                f[dataset] = np.arange(BLOCK) + 100 * k


def _virtual(path, mappings, dims=0, fill=-1):
    """A virtual dataset "v" (int64, unlimited, ``dims`` rows at first) of
    ``mappings`` [(virtual selection, source file, source dataset, source
    dataspace and its selection)], selections as callables on the spaces."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_fill_value(np.array([fill]))
    for virtual_sel, file_name, dataset, source_dims, source_sel in mappings:
        virtual = h5py.h5s.create_simple((dims,), (UNLIMITED,))
        virtual_sel(virtual)
        source = h5py.h5s.create_simple(source_dims, (UNLIMITED,))
        source_sel(source)
        dcpl.set_virtual(virtual, file_name, dataset, source)
    with h5py.File(path, "w", libver="latest") as f:
        h5py.h5d.create(f.id, b"v", h5py.h5t.STD_I64LE,
                        h5py.h5s.create_simple((dims,), (UNLIMITED,)), dcpl=dcpl)


def _by_block(virtual, start=0, stride=BLOCK):
    virtual.select_hyperslab((start,), (UNLIMITED,), stride=(stride,), block=(BLOCK,))


def _one_block(source):
    source.select_hyperslab((0,), (1,), block=(BLOCK,))


def _printf_files(n):
    def make(path):
        _block_files(path.parent, n)
        _virtual(path, [(_by_block, b"src_%b.h5", b"x", (BLOCK,), _one_block)])
    return make


def _percent(path):
    """``%%`` in a source file's name is a ``%``; blocks with gaps between
    them, the source selection "all"."""
    _block_files(path.parent, 3, pattern="src%_{}.h5")
    _virtual(path, [(lambda v: _by_block(v, start=2, stride=BLOCK + 3), b"src%%_%b.h5", b"x",
                     (BLOCK,), lambda s: s.select_all())])


def _printf_dataset(path):
    """``%b`` in the source dataset's name, the sources in this file."""
    with h5py.File(path.parent / "blocks.h5", "w") as f:
        for k in range(4):
            f[f"x{k}"] = np.arange(BLOCK) + 100 * k
    _virtual(path, [(_by_block, b"blocks.h5", b"x%b", (BLOCK,), _one_block)])


def _missing_block(path):
    """Block 1 of four missing: blocks 1 to 3 read as the fill value (HDF5
    maps blocks up to the first missing source), the extent set by a
    second, limited mapping."""
    _block_files(path.parent, 4, skip=(1,))
    _block_files(path.parent, 1, pattern="tail_{}.h5")

    def tail(virtual):
        virtual.select_hyperslab((4 * BLOCK + 2,), (1,), block=(BLOCK,))

    _virtual(path, [(_by_block, b"src_%b.h5", b"x", (BLOCK,), _one_block),
                    (tail, b"tail_0.h5", b"x", (BLOCK,), _one_block)], dims=5 * BLOCK + 2)


def _missing_alone(path):
    """Block 2 of four missing and nothing else mapped: the extent ends
    with block 1."""
    _block_files(path.parent, 4, skip=(2,))
    _virtual(path, [(_by_block, b"src_%b.h5", b"x", (BLOCK,), _one_block)], dims=40)


def _growing(path, grow):
    """An unlimited mapping of source rows 3.. of a resizable source into
    virtual rows 1.., read before the source grows and (``grow``) after."""
    with h5py.File(path.parent / "grows.h5", "w") as f:
        f.create_dataset("x", data=np.arange(11), maxshape=(None,), chunks=(4,))

    def contiguous(start):
        return lambda space: space.select_hyperslab((start,), (UNLIMITED,), stride=(1,),
                                                    block=(1,))

    _virtual(path, [(contiguous(1), b"grows.h5", b"x", (11,), contiguous(3))], dims=2)
    if grow:
        with h5py.File(path.parent / "grows.h5", "a") as f:
            f["x"].resize((30,))
            f["x"][11:] = np.arange(11, 30) * 10


def _gaps(path):
    """Unlimited counts of 2-row blocks 3 rows apart on both sides, over a
    source of 16 rows (a partial last block), and an unlimited block."""
    with h5py.File(path.parent / "src.h5", "w") as f:
        f.create_dataset("x", data=np.arange(16) + 50, maxshape=(None,), chunks=(4,))

    def gapped(start):
        return lambda space: space.select_hyperslab((start,), (UNLIMITED,), stride=(3,),
                                                    block=(2,))

    def whole(start):
        return lambda space: space.select_hyperslab((start,), (1,), block=(UNLIMITED,))

    _virtual(path, [(gapped(1), b"src.h5", b"x", (16,), gapped(0))])
    _virtual(path.parent / "whole.h5", [(whole(4), b"src.h5", b"x", (16,), whole(5))])


UNLIMITED_CASES = {
    "printf_three": _printf_files(3), "printf_four": _printf_files(4), "percent": _percent,
    "printf_dataset": _printf_dataset, "missing_block": _missing_block,
    "missing_alone": _missing_alone, "grown_before": lambda p: _growing(p, False),
    "grown_after": lambda p: _growing(p, True), "gaps": _gaps,
}


@pytest.mark.parametrize("case", sorted(UNLIMITED_CASES))
def test_unlimited_reads_like_h5py(tmp_path, monkeypatch, case):
    """Each unlimited mapping resolves as HDF5 resolves it: the shape h5py
    gives, the rows whole and in every slice of up to 3 rows and across
    blocks, the fill value where no source maps."""
    monkeypatch.chdir(tmp_path)
    UNLIMITED_CASES[case](tmp_path / "virtual.h5")
    names = ["virtual.h5"] + (["whole.h5"] if case == "gaps" else [])
    for name in names:
        with h5py.File(tmp_path / name, "r") as ref, hdf5.File(tmp_path / name) as ours:
            theirs, mine = ref["v"], ours["v"]
            assert mine.shape == theirs.shape and theirs.shape[0] > BLOCK, (name, theirs.shape)
            want = theirs[()]
            assert mine[()].tobytes() == want.tobytes(), (name, mine[()], want)
            n = theirs.shape[0]
            for lo in range(n):
                for hi in (lo + 1, lo + 3, lo + BLOCK + 1):
                    assert mine[lo:hi].tobytes() == want[lo:hi].tobytes(), (name, lo, hi)
            assert ours.walked["virtual mapping"] > 0
    if case == "missing_block":
        assert (want[BLOCK : 4 * BLOCK] == -1).all() and (want[4 * BLOCK + 2:] >= 0).all()
    if case == "grown_after":
        assert want.tolist() == [-1] + list(range(3, 11)) + [v * 10 for v in range(11, 30)]


def test_sources_open_with_the_files_mode(tmp_path, monkeypatch):
    """A source file opens with the virtual file's mode ("r" or "r+"), once
    however many mappings name it, and closes with it."""
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "virtual.h5"
    _sibling(path, np.random.RandomState(1), "earliest")
    for mode in ("r", "r+"):
        f = hdf5.File(path, mode)
        f["v"][:]
        f["converted"][:]
        sources = [other for other in f._externals.values() if other is not f]
        assert [(os.path.basename(s.filename), s.mode) for s in sources] == [("sources.h5",
                                                                             mode)]
        f.close()
        assert sources[0]._fd is None


@pytest.mark.parametrize("run", sorted(RUNS))
def test_jax_calls_from_the_virtual_fixture(tmp_path, run):
    """The JAX CLI through h5py against the port's CLI from
    tests/data/example_virtual.cool (pixel columns over two sibling
    files, bins/end within the file), the loops the example's 89."""
    with hdf5.File(VIRTUAL_COOL) as f:
        assert all(f[f"pixels/{c}"]._class == 3 for c in ("bin1_id", "bin2_id", "count"))
        assert f["bins/end"]._class == 3
    assert_jax_calls(tmp_path, str(VIRTUAL_COOL), run)
    if run == "loops":
        assert len((tmp_path / "port.tsv").read_text().splitlines()) == 90
