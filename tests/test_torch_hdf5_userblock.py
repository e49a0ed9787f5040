"""Writing into HDF5 files with a user block and offsets and lengths of
2, 4 or 8 bytes (``chromosight_torch.io.hdf5``), against h5py, which is
the oracle here and nowhere in the port:

* files h5py makes with ``set_userblock`` (512 and 4,096 bytes, a text
  header at their start) and ``set_sizes`` (4 and 4, 8 and 8, 4 and 8,
  and 2 and 2 where the data fit 64 KiB; 8 and 4, and 4 and 2, at
  "earliest" only), at libver "earliest"
  (superblock 0, symbol-table groups) and "latest" (superblock 3,
  new-style groups; HDF5 opens no unlimited dataset of layout 4 with
  lengths under 8 bytes, so those are fixed there): the port stores a
  weight column into each, replaces it, adds links until a new-style
  group turns dense, and h5py reads every dataset, the user block's
  bytes unchanged;
* the user-block fixtures of tests/test_torch_hdf5_features.py: ICE's
  weights stored into each by ``--norm force`` are those of ICE on
  example.cool bit for bit (that file's ``test_norm_force_on_fixtures``
  compares the tables too), and the user block is untouched;
* the port's own ``hdf5.write`` / ``write_cooler_layout(userblock=...,
  sizes=...)``: h5py reads what it writes (``userblock_size`` included),
  and the port reads it back, ICE's weights stored into it too;
* a write that would end past what the offsets address raises OSError
  (EFBIG) before writing: an address past 2^32 - 1 for 4-byte offsets,
  64 KiB for 2-byte ones.
"""

import contextlib
import errno
import io
import os
import shutil

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from chromosight_torch.cli.main import main  # noqa: E402
from chromosight_torch.io import hdf5, hdf5_write  # noqa: E402
from chromosight_torch.io.cool import bins_frame, write_cooler_layout  # noqa: E402
from chromosight_torch.io.source import ArraySource, CoolSource  # noqa: E402
from chromosight_torch.ops.balance import ice_balance  # noqa: E402
from test_torch_hdf5_features import (  # noqa: E402
    EXAMPLE_COOL,
    USERBLOCK_TEXT,
    USERBLOCKS,
    fixture_uri,
)
from test_torch_hdf5_formats import assert_reads_like_h5py  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402, F401

HEADER = b"# written by a tool that prepends a header\n"
CASES = [(ub, sizes, libver) for ub in (512, 4096) for sizes in ((4, 4), (8, 8), (4, 8), (2, 2))
         for libver in ("earliest", "latest")]
# offsets wider than lengths: a symbol-table entry's name offset is a length
CASES += [(ub, sizes, "earliest") for ub in (512, 4096) for sizes in ((8, 4), (4, 2))]


def quiet(fn, *args, **kwargs):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def h5py_file(path, userblock, sizes, libver):
    """A new h5py file of that user block, those sizes and libver."""
    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_userblock(userblock)
    fcpl.set_sizes(*sizes)
    fapl = h5py.h5p.create(h5py.h5p.FILE_ACCESS)
    low = h5py.h5f.LIBVER_LATEST if libver == "latest" else h5py.h5f.LIBVER_EARLIEST
    fapl.set_libver_bounds(low, h5py.h5f.LIBVER_LATEST)
    return h5py.File(h5py.h5f.create(str(path).encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl))


def small_tables(rng):
    """A cooler's bins and pixels small enough for 2-byte offsets."""
    n = 60
    b1 = np.sort(rng.randint(0, n, 300))
    b2 = np.minimum(b1 + rng.randint(0, 8, 300), n - 1)
    keep = np.unique(b1 * n + b2, return_index=True)[1]
    return {
        "bins/start": np.arange(n, dtype=np.int64) * 1000,
        "pixels/bin1_id": b1[keep].astype(np.int64),
        "pixels/bin2_id": b2[keep].astype(np.int64),
        "pixels/count": rng.randint(1, 50, len(keep)).astype(np.int32),
    }


@pytest.mark.parametrize("userblock,sizes,libver", CASES,
                         ids=[f"{u}-{s[0]}{s[1]}-{v}" for u, s, v in CASES])
def test_store_into_h5py_files(tmp_path, userblock, sizes, libver):
    """The port adds ``bins/weight`` to an h5py file, replaces it, and adds
    links past a new-style group's compact limit (not with 2-byte lengths,
    where HDF5's own dense storage fails): h5py reads every dataset, its
    ``userblock_size`` stays, and the user block keeps its header."""
    rng = np.random.RandomState(userblock + sizes[0])
    tables = small_tables(rng)
    path = tmp_path / "f.h5"
    chunked = dict(chunks=(64,), compression="gzip", shuffle=True)
    with h5py_file(path, userblock, sizes, libver) as f:
        f.attrs["bin-size"] = 1000
        f.attrs["format"] = "HDF5::Cooler"
        for name, value in tables.items():
            opts = chunked if name.startswith("pixels/") else {}
            if opts and (libver == "earliest" or sizes[1] == 8):
                opts = dict(opts, maxshape=(None,))
            f.create_dataset(name, data=value, **opts)
    with open(path, "r+b") as handle:
        handle.write(HEADER)
    weights = rng.rand(60)
    more = 12 if sizes[1] > 2 else 4
    with hdf5.File(path, "r+") as f:
        f.write_dataset("bins/weight", np.zeros(60), {"converged": 1})
        f.write_dataset("bins/weight", weights, {"min_nnz": 10, "tol": 1e-5})
        for i in range(more):
            f.write_dataset(f"bins/extra{i}", np.arange(i + 1.0))
        assert (f._so, f._sl, f._base) == (*sizes, userblock)
    with h5py.File(path, "r") as f:
        assert f.userblock_size == userblock
        assert f["bins/weight"][()].tobytes() == weights.tobytes()
        assert dict(f["bins/weight"].attrs) == {"min_nnz": 10, "tol": 1e-5}
        assert f[f"bins/extra{more - 1}"][()].tolist() == list(range(more))
        for name, value in tables.items():
            assert f[name][()].tobytes() == value.tobytes(), name
    assert path.read_bytes()[: len(HEADER)] == HEADER
    assert_reads_like_h5py(path)


@pytest.mark.parametrize("name", sorted(USERBLOCKS))
def test_norm_force_keeps_the_user_block(tmp_path, name):
    """ICE stores its weights into a copy of each user-block fixture (the
    port's CLI, ``--norm force``): those of ICE on example.cool bit for
    bit, read by h5py, and the user block's bytes are unchanged."""
    src = fixture_uri(name)
    dst = tmp_path / os.path.basename(src)
    shutil.copy(src, dst)
    userblock = USERBLOCKS[name][0]
    block = dst.read_bytes()[:userblock]
    assert block.startswith(USERBLOCK_TEXT)
    quiet(main, ["detect", "--no-plotting", "--norm", "force", str(dst), str(tmp_path / "out")],
          device="cpu")
    weights = ice_balance(CoolSource(EXAMPLE_COOL), store=False)
    assert np.isfinite(weights).sum() == 637
    with h5py.File(dst, "r") as f:
        assert f.userblock_size == userblock
        assert f["bins/weight"][()].tobytes() == weights.tobytes()
    assert dst.read_bytes()[:userblock] == block


LAYOUTS = [(0, (8, 8), "earliest"), (512, (4, 4), "earliest"), (4096, (4, 4), "earliest"),
           (512, (8, 8), "latest"), (4096, (4, 8), "latest"), (512, (4, 8), "earliest")]


@pytest.mark.parametrize("userblock,sizes,libver", LAYOUTS,
                         ids=[f"{u}-{s[0]}{s[1]}-{v}" for u, s, v in LAYOUTS])
def test_write_cooler_layout_read_by_h5py(tmp_path, userblock, sizes, libver):
    """The example written weightless by ``write_cooler_layout(userblock=,
    sizes=)``: h5py reads every table and the user block's size, the
    port reads it back, and ICE's weights stored into it are those of ICE
    on example.cool bit for bit, read by h5py."""
    src = CoolSource(EXAMPLE_COOL)
    bins = bins_frame(src).drop(columns="weight")
    pixels = dict(zip(("bin1_id", "bin2_id", "count"), src._pixels(0, src.nnz)))
    path = tmp_path / "w.cool"
    write_cooler_layout(path, bins, pixels, libver=libver, userblock=userblock, sizes=sizes)
    if userblock:
        with open(path, "r+b") as handle:
            handle.write(HEADER)
    with h5py.File(path, "r") as f:
        assert f.userblock_size == userblock and "weight" not in f["bins"]
        assert f["pixels/count"][()].tolist() == src._pixels(0, src.nnz)[2].tolist()
        assert f["indexes/bin1_offset"][()].tolist() == src._bin1_offset.tolist()
    ours = CoolSource(path)
    assert (ours._file._so, ours._file._sl, ours._file._base) == (*sizes, userblock)
    assert ours.nnz == src.nnz and ours.chromnames == src.chromnames
    got = ice_balance(CoolSource(path), store=True)
    want = ice_balance(src, store=False)
    assert got.tobytes() == want.tobytes() and np.isfinite(got).sum() == 637
    with h5py.File(path, "r") as f:
        assert f["bins/weight"][()].tobytes() == want.tobytes()
    if userblock:
        assert path.read_bytes()[: len(HEADER)] == HEADER
    assert_reads_like_h5py(path)


def test_write_refuses_bad_options(tmp_path):
    data = {"x": np.arange(3)}
    for userblock in (100, 768, 256):
        with pytest.raises(ValueError, match="userblock"):
            hdf5.write(tmp_path / "a.h5", data, userblock=userblock)
    with pytest.raises(ValueError, match="sizes"):
        hdf5.write(tmp_path / "a.h5", data, sizes=(3, 8))
    with pytest.raises(ValueError, match="8-byte lengths"):
        hdf5.write(tmp_path / "a.h5", data, chunks={"x": 2}, libver="latest", sizes=(8, 4))


def test_past_the_offsets_reach_raises(tmp_path):
    """A block that would end past 2^32 - 1 with 4-byte offsets raises
    OSError (EFBIG) before a byte is written (the appender of a file whose
    end is near it, on a sparse file); with 2-byte offsets ``write`` of
    more than 64 KiB raises, and ``write_dataset`` too, leaving the file
    as it was."""
    path = tmp_path / "sparse.bin"
    fd = os.open(path, os.O_RDWR | os.O_CREAT)
    try:
        out = hdf5_write.Appender(fd, (1 << 32) - 4096, 512, 4, 4)
        assert out.put(bytes(1024)) == (1 << 32) - 4096
        with pytest.raises(OSError) as err:
            out.put(bytes(8192))
        assert err.value.errno == errno.EFBIG and "4-byte offsets" in str(err.value)
        assert os.fstat(fd).st_size == 512 + (1 << 32) - 4096 + 1024
    finally:
        os.close(fd)
    with pytest.raises(OSError, match="2-byte offsets"):
        hdf5.write(tmp_path / "big.h5", {"x": np.zeros(9000)}, sizes=(2, 2))
    small = hdf5.write(tmp_path / "small.h5", {"x": np.arange(10)}, sizes=(2, 2), userblock=512)
    before = open(small, "rb").read()
    with hdf5.File(small, "r+") as f, pytest.raises(OSError, match="2-byte offsets"):
        f.write_dataset("y", np.zeros(9000))
    assert open(small, "rb").read() == before
    with h5py.File(small, "r") as f:
        assert f["x"][()].tolist() == list(range(10)) and f.userblock_size == 512


def test_user_block_genome_layout_small(tmp_path):
    """The card's ``userblock-genome`` phase at a small size: a synthetic
    genome written weightless in cooler's layout with a 512-byte user
    block (its text header) and 4-byte offsets; detect at ``--norm
    auto`` balances it and stores the weights (those of ICE on the same
    tables in memory, bit for bit), a second run reuses them, ``--norm
    force`` replaces them, and every table equals the one from memory."""
    genome = ArraySource.from_synthetic(2, 1500, seed=0)
    bins = bins_frame(genome).drop(columns="weight")
    pixels = dict(zip(("bin1_id", "bin2_id", "count"), genome._pixels(0, genome.nnz)))
    path = tmp_path / "genome.cool"
    write_cooler_layout(path, bins, pixels, userblock=512, sizes=(4, 4))
    with open(path, "r+b") as handle:
        handle.write(HEADER)
    block = path.read_bytes()[:512]
    want = genome.weights
    memory = tmp_path / "memory.npz"
    genome.to_npz(memory)
    quiet(main, ["detect", "--no-plotting", str(memory), str(tmp_path / "mem")], device="cpu")
    table = (tmp_path / "mem.tsv").read_bytes()
    for run, norm in enumerate(("auto", "auto", "force")):
        quiet(main, ["detect", "--no-plotting", "--norm", norm, str(path),
                     str(tmp_path / f"run{run}")], device="cpu")
        assert (tmp_path / f"run{run}.tsv").read_bytes() == table, run
        assert CoolSource(path).weights.tobytes() == want.tobytes(), run
    assert path.read_bytes()[:512] == block
    with h5py.File(path, "r") as f:
        assert f["bins/weight"][()].tobytes() == want.tobytes()
