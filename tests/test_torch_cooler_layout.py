"""cooler's own layout (every dataset chunked, shuffle + gzip 6, int64
pixel ids, an enum ``bins/chrom``) through the port's HDF5 code
(``chromosight_torch.io.hdf5``), held to h5py and to the JAX package.

* The HDF5 filters: ``native/lzf.cpp`` and its Python decoder give the
  same bytes on every LZF chunk of tests/data/example_latest.mcool, and
  the same error on a broken block; under CHROMOSIGHT_TPU_NO_NATIVE the
  file reads as natively; ``native/shuffle.cpp`` equals the numpy
  shuffle and unshuffle for elements of 1, 2, 4 and 8 bytes, with and
  without trailing bytes.
* The writer's chunked layout (``hdf5.write(..., chunks=)``,
  ``cool.write_cooler_layout``): h5py reads every file it makes equal to
  the arrays, through chunk B-trees of one to three levels, an enum and
  an ``.mcool`` group, and the bytes do not depend on the thread count.
* The reader: h5py-written cooler-layout columns at several chunk sizes
  read as h5py reads them, whole and in slices across chunk edges,
  through ``native/inflate.cpp`` on one thread or several and through
  the Python decoding; a chunk the native batch cannot decode is left to
  the Python decoding, which raises.
* A port-written ``.mcool::/resolutions/1000`` copy of
  data_test/example.cool gives the JAX package's loops, borders and
  quantify calls through the port.

Run as a script (``PYTHONPATH=. python tests/test_torch_cooler_layout.py
FILE [CHECKOUT ...]`` from the repository's root) it times the port's
read of a 24,000,000-pixel cooler-layout file against h5py's (see
``time_reads``).
"""

import argparse
import contextlib
import io
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest

h5py = pytest.importorskip("h5py")

from chromosight_torch import native  # noqa: E402
from chromosight_torch.cli.main import main  # noqa: E402
from chromosight_torch.io import hdf5  # noqa: E402
from chromosight_torch.io.cool import bins_frame, chunk_rows, write_cooler_layout  # noqa: E402
from chromosight_torch.io.source import CoolSource  # noqa: E402
from test_torch_hdf5_formats import (  # noqa: E402
    assert_reads_like_h5py,
    boundary_slices,
    h5py_chunks,
)
from torch_parity import torch_one_thread  # noqa: E402, F401

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
EXAMPLE_COOL = ROOT / "data_test" / "example.cool"
LATEST_MCOOL = DATA / "example_latest.mcool"
COOLER_OPTS = dict(compression="gzip", compression_opts=6, shuffle=True)
# the cooler-layout timing file: pixel columns of a synthetic 48,000-bin
# chromosome cut to 24,000,000 rows, in the chunks h5py's guess_chunk picks
# for resizable columns created at 5 x 624,000 rows
TIMING_ROWS = 24_000_000
TIMING_CHUNKS = {"pixels/bin2_id": 6_094, "pixels/count": 12_188}


def lzf_chunks(path):
    """(stored bytes, decoded size) of every LZF chunk of ``path``."""
    found = []
    with hdf5.File(path) as f:
        datasets, groups = [], [f.root]
        while groups:
            group = groups.pop()
            for name in group.keys():
                obj = group[name]
                (groups if isinstance(obj, hdf5.Group) else datasets).append(obj)
        for d in datasets:
            if d._class != 2 or hdf5.LZF not in [fid for fid, _ in d._filters]:
                continue
            offsets, addrs, sizes, masks = d._chunk_index()
            for addr, size in zip(addrs, sizes):
                found.append((f._read(int(addr), int(size)), d._chunk_bytes))
    return found


def test_lzf_decoders_agree_on_every_chunk():
    """``lzf.cpp`` and ``lzf_decompress_py`` decode every LZF chunk of the
    .mcool fixture to the same bytes, and a block cut short, one with a
    byte too many and one asked for a byte less all raise the same
    OSError from both."""
    assert native.filters_native()
    chunks = lzf_chunks(LATEST_MCOOL)
    assert len(chunks) > 40
    for raw, size in chunks:
        assert native.lzf_decompress(raw, size) == native.lzf_decompress_py(raw, size)
    raw, size = chunks[0]
    for bad, want in ((raw[:-1], size), (raw + b"\0", size), (raw, size - 1)):
        errors = []
        for decode in (native.lzf_decompress, native.lzf_decompress_py):
            with pytest.raises(OSError) as err:
                decode(bad, want)
            errors.append(str(err.value))
        assert errors[0] == errors[1]


NO_NATIVE_READ = """
import hashlib, json, sys
from chromosight_torch import native
from chromosight_torch.io import hdf5
assert not native.filters_native() and native.get_lib() is None
digests = {}
with hdf5.File(sys.argv[1]) as f:
    groups = [f.root]
    while groups:
        group = groups.pop()
        for name in group.keys():
            obj = group[name]
            if isinstance(obj, hdf5.Group):
                groups.append(obj)
            else:
                digests[obj.name] = hashlib.sha256(obj[()].tobytes()).hexdigest()
    print(json.dumps({"digests": digests, "lzf": f.walked["LZF chunk"]}))
"""


def test_lzf_mcool_reads_without_native_code():
    """Under CHROMOSIGHT_TPU_NO_NATIVE=1 (a subprocess: no native library,
    the Python LZF decoder and the numpy unshuffle) every dataset of the
    LZF .mcool fixture reads to the bytes the native read gives."""
    import hashlib
    import json

    env = dict(os.environ, CHROMOSIGHT_TPU_NO_NATIVE="1", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", NO_NATIVE_READ, str(LATEST_MCOOL)], env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    got = json.loads(out.stdout)
    assert got["lzf"] > 40
    with hdf5.File(LATEST_MCOOL) as f:
        for name, digest in got["digests"].items():
            assert hashlib.sha256(f[name][()].tobytes()).hexdigest() == digest, name
        assert len(got["digests"]) == 91


@pytest.mark.parametrize("size", [1, 2, 4, 8])
@pytest.mark.parametrize("trailing", [0, 3], ids=["whole", "trailing"])
def test_native_shuffle_equals_numpy(size, trailing):
    """``shuffle.cpp``'s unshuffle and shuffle give the numpy versions'
    bytes, into a new buffer and into a given one, for elements of
    ``size`` bytes at chunk lengths around its 8-element blocks, with
    ``trailing`` bytes past the last element left in place."""
    assert native.filters_native()
    rng = np.random.RandomState(size)
    for n in (0, 1, 7, 8, 9, 64, 1001, 6_094):
        raw = rng.randint(0, 256, n * size + trailing).astype(np.uint8).tobytes()
        plain = native.unshuffle_numpy(raw, size)
        assert native.unshuffle(raw, size) == plain
        into = bytearray(len(raw))
        native.unshuffle(raw, size, into)
        assert bytes(into) == plain
        assert native.shuffle(plain, size) == native.shuffle_numpy(plain, size) == raw


# -- the writer, read by h5py ---------------------------------------------- #

def _enum_and_filters(rng):
    enum = hdf5.enum_dtype({"chr1": 0, "chr2": 1, "chrM": 2})
    arrays = {"bins/chrom": rng.randint(0, 3, 720).astype(np.int32).view(enum),
              "pixels/count": rng.randint(0, 500, 109_975).astype(np.int32),
              "f8": rng.rand(50, 7), "names": np.array([b"chr1", b"chr22", b"chrM"], "S32"),
              "empty": np.zeros(0, np.int64)}
    return arrays, {"bins/chrom": 100, "pixels/count": 8192, "f8": 8, "names": 2, "empty": 16}


def _deep_btree(rng):
    arrays = {"pixels/bin2_id": np.sort(rng.randint(0, 720, 5_000)).astype(np.int64)}
    return arrays, {"pixels/bin2_id": 1}


def _mcool_group(rng):
    arrays = {f"resolutions/{res}/pixels/{col}": rng.randint(0, 99, 3_000).astype(np.int64)
              for res in (1000, 5000) for col in ("bin2_id", "count")}
    return arrays, {name: 100 for name in arrays}


WRITER_CASES = {"enum_and_filters": _enum_and_filters, "deep_btree": _deep_btree,
                "mcool_group": _mcool_group}


def btree_level(path, name):
    """The level of the root of dataset ``name``'s chunk B-tree."""
    with hdf5.File(path) as f:
        d = f[name]
        return f._btree(d._btree_addr, 8 + 8 * (len(d.shape) + 1))[0]


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_h5py_reads_the_chunked_writer(tmp_path, monkeypatch, case):
    """``hdf5.write`` with ``chunks``: h5py reads every dataset equal to
    its array (dtype, bytes, shuffle + gzip 6, unlimited first axis, the
    chunks asked for, every chunk h5py's index walk finds), in slices
    across chunk edges too, an enum as an enum and the groups' attributes;
    5,000 one-row chunks make a B-tree of three levels (root level 2);
    the port reads it as h5py does, and written on one thread or four the
    file's bytes are the same."""
    arrays, chunks = WRITER_CASES[case](np.random.RandomState(7))
    group_attrs = {"resolutions/5000": {"bin-size": 5000}} if case == "mcool_group" else None
    paths = []
    for threads in (1, 4):
        monkeypatch.setattr(hdf5, "THREADS", threads)
        paths.append(tmp_path / f"{threads}.h5")
        hdf5.write(paths[-1], arrays, {"format": "test"}, chunks=chunks,
                   group_attrs=group_attrs)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    with h5py.File(paths[0], "r") as f:
        assert f.attrs["format"] == "test"
        for name, array in arrays.items():
            d = f[name]
            assert d.dtype == np.dtype(array.dtype.str) and d[()].tobytes() == array.tobytes()
            assert (d.compression, d.compression_opts, d.shuffle) == ("gzip", 6, True)
            assert d.chunks == (chunks[name], *array.shape[1:]) and d.maxshape[0] is None
            assert len(h5py_chunks(d)) == -(-len(array) // chunks[name])
            for lo, hi in boundary_slices(len(array), chunks[name]):
                assert d[lo:hi].tobytes() == array[lo:hi].tobytes(), (name, lo, hi)
        if case == "enum_and_filters":
            assert h5py.check_enum_dtype(f["bins/chrom"].dtype) == {"chr1": 0, "chr2": 1,
                                                                   "chrM": 2}
        if case == "mcool_group":
            assert dict(f["resolutions/5000"].attrs) == {"bin-size": 5000}
    if case == "deep_btree":
        assert btree_level(paths[0], "pixels/bin2_id") == 2
    assert_reads_like_h5py(paths[0])


# -- the reader, against h5py ------------------------------------------- #

@pytest.mark.parametrize("rows", [97, 1_000, 6_094, 12_188, 50_000])
def test_reads_h5py_cooler_columns(tmp_path, monkeypatch, rows):
    """Cooler-layout columns h5py writes (int64 ids, int32 counts, chunks
    of ``rows`` rows, resizable, shuffle + gzip 6) read whole and in
    slices across chunk edges as h5py reads them, bit for bit: through
    ``inflate.cpp`` on the reader's threads and on one, and through the
    Python decoding (the native batch turned off)."""
    rng = np.random.RandomState(rows)
    n = 40_000
    columns = {"bin2_id": np.sort(rng.randint(0, 1 << 40, n)).astype(np.int64),
               "count": rng.poisson(3, n).astype(np.int32)}
    path = tmp_path / "c.cool"
    with h5py.File(path, "w") as f:
        for name, data in columns.items():
            f.create_dataset(name, data=data, chunks=(min(rows, n),), maxshape=(None,),
                             **COOLER_OPTS)
    c = min(rows, n)
    slices = boundary_slices(n, c) + [(c * k - 1, c * k + 2 * c + 1) for k in (1, 2)]
    assert native.filters_native()
    inflate = native.inflate_chunks
    for threads, batch in ((4, True), (1, True), (4, False)):
        monkeypatch.setattr(hdf5, "THREADS", threads)
        monkeypatch.setattr(native, "inflate_chunks", inflate if batch else
                            lambda *args: False)
        with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
            for name in columns:
                assert ours[name][:].tobytes() == ref[name][:].tobytes()
                for lo, hi in slices:
                    got = ours[name][lo:hi]
                    assert got.dtype == ref[name].dtype, name
                    assert got.tobytes() == ref[name][lo:hi].tobytes(), (name, lo, hi)


def test_native_inflate_leaves_a_bad_chunk_to_python(tmp_path):
    """A chunk that ``inflate.cpp`` cannot decode (its stored stream cut
    short) is left to the Python decoding, which raises zlib's error as
    before."""
    import zlib

    path = tmp_path / "c.h5"
    hdf5.write(path, {"x": np.arange(10_000, dtype=np.int64)}, chunks={"x": 1000})
    with hdf5.File(path) as f:
        d = f["x"]
        _, addrs, sizes, _ = d._chunk_index()
        good = f._read(int(addrs[3]), int(sizes[3]))
        flat = np.zeros(8000, np.uint8)
        assert native.inflate_chunks(np.frombuffer(good, np.uint8), [0], [len(good)], flat,
                                     [0], 8000, 8, 2)
        assert flat.view(np.int64).tolist() == list(range(3000, 4000))
    with open(path, "r+b") as handle:
        handle.seek(int(addrs[3]) + 2)
        handle.write(bytes(int(sizes[3]) - 2))
    with hdf5.File(path) as f, pytest.raises(zlib.error):
        f["x"][:]


# -- the JAX package's calls from a port-written .mcool ------------------- #

@pytest.fixture(scope="module")
def cooler_mcool(tmp_path_factory):
    """data_test/example.cool written by the port in cooler's layout as
    ``example.mcool::/resolutions/1000``; its URI."""
    path = tmp_path_factory.mktemp("mcool") / "example.mcool"
    src = CoolSource(str(EXAMPLE_COOL))
    b1, b2, ct = src._pixels(0, src.nnz)
    write_cooler_layout(path, bins_frame(src), {"bin1_id": b1, "bin2_id": b2, "count": ct},
                        group="/resolutions/1000")
    return f"{path}::/resolutions/1000"


def test_cooler_mcool_holds_the_example(cooler_mcool):
    """The port-written .mcool holds the example's tables in cooler's
    layout: int64 ids, chunks of h5py's choice, gzip + shuffle, an enum
    of the chromosome names, the attributes on the resolution group."""
    path, _, group = cooler_mcool.partition("::")
    src = CoolSource(str(EXAMPLE_COOL))
    with h5py.File(path, "r") as f, h5py.File(EXAMPLE_COOL, "r") as ref:
        assert f.attrs["format"] == "HDF5::MCOOL"
        g = f[group]
        assert g.attrs["bin-size"] == 1000 and g.attrs["nnz"] == src.nnz
        assert h5py.check_enum_dtype(g["bins/chrom"].dtype) == {
            name: i for i, name in enumerate(src.chromnames)}
        for col in ("bin1_id", "bin2_id", "count"):
            d = g[f"pixels/{col}"]
            assert d.compression == "gzip" and d.shuffle and d.maxshape == (None,)
            assert d.chunks == (chunk_rows(src.nnz, d.dtype.itemsize),)
            assert np.array_equal(d[()], ref[f"pixels/{col}"][()])
        assert g["pixels/bin1_id"].dtype == np.int64
        assert np.array_equal(g["bins/weight"][()], ref["bins/weight"][()], equal_nan=True)


def _quiet(fn, args):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        return fn(args)


RUNS = {"loops": ["detect", "--no-plotting"],
        "borders": ["detect", "--no-plotting", "--pattern", "borders"],
        "quantify": ["quantify", "--no-plotting", str(ROOT / "data_test" / "example.bed2")]}


def assert_jax_calls(tmp_path, uri, run):
    """The JAX package's CLI (h5py reading ``uri``) and the port's
    (``device="cpu"``, its own reader) from ``uri``: the same rows and
    coordinates, scores within 5e-5 and p-values within 1e-5
    (tests/test_golden_outputs.py's bounds)."""
    from chromosight_tpu.cli.main import main as jax_main

    assert _quiet(jax_main, [*RUNS[run], uri, str(tmp_path / "jax")]) in (0, None)
    assert _quiet(lambda a: main(a, device="cpu"), [*RUNS[run], uri, str(tmp_path / "port")]) == 0
    ref = pd.read_csv(tmp_path / "jax.tsv", sep="\t")
    ours = pd.read_csv(tmp_path / "port.tsv", sep="\t")
    assert list(ours.columns) == list(ref.columns) and len(ours) == len(ref) > 0
    coords = [c for c in ref.columns if c in ("chrom1", "start1", "end1", "chrom2", "start2",
                                              "end2", "bin1", "bin2")]
    for col in coords:
        assert ours[col].fillna(-1).equals(ref[col].fillna(-1)), col
    for col, tol in (("score", 5e-5), ("pvalue", 1e-5)):
        assert (ours[col].isna() == ref[col].isna()).all(), col
        assert np.nanmax(np.abs(ours[col] - ref[col])) < tol, col


@pytest.mark.parametrize("run", sorted(RUNS))
def test_jax_calls_from_the_cooler_mcool(tmp_path, cooler_mcool, run):
    """The JAX package's CLI and the port's from the port-written .mcool
    (``assert_jax_calls``)."""
    assert_jax_calls(tmp_path, cooler_mcool, run)

PORT_READ = """
import sys, time
from chromosight_torch.io import hdf5
t0 = time.perf_counter()
with hdf5.File(sys.argv[1]) as f:
    n = sum(f[name][:].nbytes for name in sys.argv[2:])
print(time.perf_counter() - t0, n)
"""


def write_timing_file(path):
    """The timing file, written with h5py: int64 ``bin2_id`` and int32
    ``count`` of ``synth_chrom(48000)`` (seed 0), cut to ``TIMING_ROWS``,
    chunked (``TIMING_CHUNKS``), resizable, gzip 6 + shuffle."""
    from chromosight_torch.io.source import synth_chrom

    _, cols, vals, _ = synth_chrom(48_000, np.random.RandomState(0))
    columns = {"pixels/bin2_id": cols[:TIMING_ROWS].astype(np.int64),
               "pixels/count": vals[:TIMING_ROWS].astype(np.int32)}
    with h5py.File(path, "w") as f:
        for name, data in columns.items():
            f.create_dataset(name, data=data, chunks=(TIMING_CHUNKS[name],), maxshape=(None,),
                             compression="gzip", compression_opts=6, shuffle=True)
    return columns


def time_reads(path, trees, repeats=3):
    """Seconds of h5py's read of both pixel columns of ``path`` whole, and
    of the port's read from each checkout in ``trees`` (a subprocess with
    that checkout first on ``PYTHONPATH``), in turns: h5py, the trees,
    then the trees reversed, ``repeats`` times; the median of each."""
    import h5py

    names = list(TIMING_CHUNKS)
    seconds = {"h5py": []}
    seconds.update({tree: [] for tree in trees})
    for _ in range(repeats):
        for tree in ["h5py", *trees, *reversed(trees)]:
            if tree == "h5py":
                t0 = time.perf_counter()
                with h5py.File(path, "r") as f:
                    for name in names:
                        f[name][:]
                seconds["h5py"].append(time.perf_counter() - t0)
                continue
            env = dict(os.environ, PYTHONPATH=str(tree))
            out = subprocess.run([sys.executable, "-c", PORT_READ, str(path), *names],
                                 env=env, capture_output=True, text=True, check=True,
                                 cwd=tree)
            seconds[tree].append(float(out.stdout.split()[0]))
    return {k: (statistics.median(v), v) for k, v in seconds.items()}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Time the port's read of a 24,000,000-pixel "
                                     "cooler-layout file against h5py's, on this host.")
    parser.add_argument("path", help="the timing file (written with h5py when missing)")
    parser.add_argument("trees", nargs="*", default=[str(ROOT)],
                        help="checkouts whose chromosight_torch reads it (default: this one)")
    args = parser.parse_args()
    if not os.path.exists(args.path):
        write_timing_file(args.path)
    info = {}
    with open("/proc/cpuinfo") as handle:
        for line in handle:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    cpu = (f"{info.get('model name', 'unknown CPU')} (family {info.get('cpu family', '?')} "
           f"model {info.get('model', '?')})")
    print(f"{args.path}: {os.path.getsize(args.path)} bytes; {cpu}, {os.cpu_count()} cores")
    for name, (median, runs) in time_reads(args.path, args.trees).items():
        print(f"{name}: median {median:.3f} s of {', '.join(f'{t:.3f}' for t in runs)}")
