"""HDF5's szip filter (filter 4: CCSDS 121.0-B through libaec's szlib
layer) in the port's HDF5 code (``chromosight_torch.io.hdf5``,
``native/aec.cpp``), against h5py, which is the oracle here and nowhere in
the port:

* every szip dataset h5py writes in a matrix of types (u1, i2, i4, i8,
  f4, f8), byte orders, options ('nn', 'ec'), blocks of 8, 16 and 32
  pixels, with and without shuffle, in chunks that are and are not whole
  scanlines, reads as h5py reads it, whole and in slices across chunk
  edges, natively and through the Python decoder; chunks h5py stored
  without szip (their filter-mask bit set) read too;
* the native decoder (on 1 and 4 threads) and ``native.aec_decode_py``
  give the same bytes on every chunk and the same OSError on a stream cut
  short or holding a code no encoder writes; a CHROMOSIGHT_TPU_NO_NATIVE
  subprocess reads the szip fixture to the native bytes;
* the port's szip writer (``hdf5.write(..., compression="szip")``,
  ``write_cooler_layout(..., compression="szip")``): h5py reads what it
  writes, with the client values h5py's own ``compression="szip"`` stores,
  and the bytes do not depend on the thread count;
* the JAX package's CLI (h5py reading tests/data/example_szip.cool and
  example_szip_shuffle_ec.cool) against the port's on the CPU.

Run as a script (``PYTHONPATH=. python tests/test_torch_hdf5_szip.py FILE
[CHECKOUT ...]`` from the repository's root) it times the port's read of
a 24,000,000-row shuffle + szip column against h5py's on this host (see
``time_reads``), then the port's gzip and szip writes and reads and
``aec.cpp`` on one thread (``time_codecs``).
"""

import argparse
import contextlib
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from chromosight_torch import native  # noqa: E402
from chromosight_torch.cli.main import main  # noqa: E402
from chromosight_torch.io import hdf5  # noqa: E402
from chromosight_torch.io.cool import bins_frame, write_cooler_layout  # noqa: E402
from chromosight_torch.io.source import CoolSource  # noqa: E402
from test_torch_cooler_layout import RUNS, assert_jax_calls  # noqa: E402
from test_torch_hdf5_formats import assert_reads_like_h5py, boundary_slices  # noqa: E402
from torch_parity import torch_one_thread  # noqa: E402, F401

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
EXAMPLE_COOL = ROOT / "data_test" / "example.cool"
SZIP_FIXTURES = (DATA / "example_szip.cool", DATA / "example_szip_shuffle_ec.cool")
ROWS = 3_000
# chunk lengths: whole scanlines of every block size (1,024 rows: 128
# blocks of 8, 64 of 16, 32 of 32), and not (700, 1,000 and 37 rows)
CHUNKS = (1_024, 700, 37)
# the timing file: a shuffle + szip bin2_id column of synth_chrom(48000)
# (seed 0) cut to 24,000,000 rows, in the chunks h5py's guess_chunk picks
# for a column created at 5 x 624,000 rows
TIMING_ROWS, TIMING_CHUNK = 24_000_000, 6_094


def szip_column(rng, dtype, rows=ROWS):
    """A column of ``dtype``: a sorted id-like run, small counts, a
    constant stretch (zero blocks) and a random tail (blocks coded
    uncompressed, chunks left unfiltered)."""
    kind = np.dtype(dtype)
    top = 255 if kind.itemsize == 1 else 30_000
    ids = np.cumsum(rng.randint(0, 3, rows // 3)) % top
    counts = rng.poisson(2, rows // 3)
    flat = np.full(rows // 6, 7)
    column = np.concatenate([ids, counts, flat])
    if kind.kind == "f":
        column = column * 0.37 + rng.rand(len(column)) * (column % 5 == 0)
    tail = np.frombuffer(rng.bytes((rows - len(column)) * kind.itemsize), kind)
    return np.concatenate([column.astype(kind), tail])


def szip_cases(dtype):
    """{name: (options, block, shuffle, chunk rows)} of the matrix for
    one type."""
    cases = {}
    for opt in ("nn", "ec"):
        for block in (8, 16, 32):
            for shuffle in (False, True):
                for rows in CHUNKS:
                    if rows >= block:
                        cases[f"{opt}{block}{'s' if shuffle else ''}_{rows}"] = (
                            opt, block, shuffle, rows)
    return cases


def write_matrix(path, dtype, rng):
    """Every case of ``szip_cases`` in one h5py file; the names."""
    with h5py.File(path, "w") as f:
        for name, (opt, block, shuffle, rows) in szip_cases(dtype).items():
            f.create_dataset(name, data=szip_column(rng, dtype), chunks=(rows,),
                             compression="szip", compression_opts=(opt, block), shuffle=shuffle)
        f.create_dataset("two_d", data=szip_column(rng, dtype, 4_200).reshape(600, 7),
                         chunks=(50, 7), compression="szip")
    return [*szip_cases(dtype), "two_d"]


def szip_chunks_of(path):
    """[(dataset, chunk bytes as stored)] of every chunk szip coded in
    ``path``."""
    found = []
    with hdf5.File(path) as f:
        datasets, groups = [], [f.root]
        while groups:
            group = groups.pop()
            for name in group.keys():
                obj = group[name]
                (groups if isinstance(obj, hdf5.Group) else datasets).append(obj)
        for d in datasets:
            kinds = [fid for fid, _ in d._filters] if d._class == 2 else []
            if hdf5.SZIP not in kinds:
                continue
            at = kinds.index(hdf5.SZIP)
            _, addrs, sizes, masks = d._chunk_index()
            for addr, size, mask in zip(addrs, sizes, masks):
                if not mask & (1 << at):
                    found.append((d, f._read(int(addr), int(size))))
    return found


# -- decoding what h5py writes --------------------------------------------- #

@pytest.mark.parametrize("dtype", ["u1", "<i2", ">i2", "<i4", ">i4", "<i8", ">i8", "<f4",
                                   ">f4", "<f8", ">f8"])
def test_szip_reads_like_h5py(tmp_path, monkeypatch, dtype):
    """Each case of the matrix reads as h5py reads it (dtype, whole, and
    slices across chunk edges) natively, and whole through the Python
    decoding (the native batch turned off and ``aec_decode`` on its
    fallback); the
    reader counts the chunks szip coded, and the random tails leave some
    chunks unfiltered."""
    path = tmp_path / "szip.h5"
    names = write_matrix(path, dtype, np.random.RandomState(len(dtype) + ord(dtype[-1])))
    assert native.filters_native()
    skipped = 0
    with h5py.File(path, "r") as ref:
        for name in names:
            d = ref[name]
            skipped += sum(d.id.get_chunk_info(i).filter_mask != 0
                           for i in range(d.id.get_num_chunks()))
    assert skipped > 0
    for mode in ("native", "python"):
        if mode == "python":
            monkeypatch.setattr(native, "szip_chunks", lambda *args: False)
            monkeypatch.setattr(native, "aec_decode", native.aec_decode_py)
        with h5py.File(path, "r") as ref, hdf5.File(path) as ours:
            for name in names:
                theirs, mine = ref[name], ours[name]
                assert mine.dtype == theirs.dtype and mine.shape == theirs.shape, name
                assert mine[()].tobytes() == theirs[()].tobytes(), (mode, name)
                if mode == "python":
                    continue  # the slices' chunks decode through the same calls
                for lo, hi in boundary_slices(theirs.shape[0], theirs.chunks[0])[:4]:
                    assert mine[lo:hi].tobytes() == theirs[lo:hi].tobytes(), (mode, name, lo)
            assert ours.walked["szip chunk"] > 0
    assert_reads_like_h5py(path)


def test_client_values_and_pipeline_as_h5py_stores_them(tmp_path):
    """The reader parses filter 4's client values as h5py reports them
    (options mask, pixels per block, bits per pixel, pixels per scanline):
    ('nn', 16) on int64 in 10,000-row chunks gives (169, 16, 64, 2048) and
    shuffle then szip ('nn', 8) in 1,000-row chunks (169, 8, 64, 1000)."""
    path = tmp_path / "values.h5"
    data = np.arange(30_000, dtype=np.int64)
    with h5py.File(path, "w") as f:
        f.create_dataset("nn16", data=data, chunks=(10_000,), compression="szip",
                         compression_opts=("nn", 16))
        f.create_dataset("default", data=data, chunks=(1_000,), compression="szip",
                         shuffle=True)
    with hdf5.File(path) as f:
        assert f["nn16"]._filters == [(hdf5.SZIP, (169, 16, 64, 2048))]
        assert f["default"]._filters == [(hdf5.SHUFFLE, (8,)), (hdf5.SZIP, (169, 8, 64, 1000))]
        assert f["nn16"][()].tolist() == data.tolist()


# -- the native and Python decoders ---------------------------------------- #

def test_decoders_agree_on_every_chunk(tmp_path):
    """On every szip chunk of the two fixtures and of an h5py file of
    every type, the native batch on 1 and 4 threads, ``aec_decode`` and
    ``aec_decode_py`` give the same bytes; a stream cut short, a chunk
    asking for a byte more, a flipped bit in a stream and options outside
    HDF5's raise the same OSError from both decoders."""
    assert native.filters_native()
    rng = np.random.RandomState(3)
    chunks = []
    for dtype in ("u1", ">i2", "<i4", "<i8", ">f8"):
        path = tmp_path / f"{dtype[-2:]}.h5"
        write_matrix(path, dtype, rng)
        chunks += szip_chunks_of(path)
    for path in SZIP_FIXTURES:
        chunks += szip_chunks_of(path)
    assert len(chunks) > 500
    for d, raw in chunks:
        values = d._filters[[fid for fid, _ in d._filters].index(hdf5.SZIP)][1]
        size = int.from_bytes(raw[:4], "little")
        plain = native.aec_decode_py(raw[4:], values, size)
        assert native.szip_decode(raw, values, size) == plain
        for threads in (1, 4):
            out = np.zeros(2 * size, np.uint8)
            assert native.szip_chunks(np.frombuffer(raw * 2, np.uint8), [0, len(raw)],
                                      [len(raw)] * 2, out, [0, size], size, values, 1,
                                      threads)
            assert out.tobytes() == plain * 2
    d, raw = max(chunks, key=lambda c: len(c[1]))
    values = d._filters[-1][1]
    size = int.from_bytes(raw[:4], "little")
    flipped = bytearray(raw)
    flipped[len(raw) // 2] ^= 0xFF
    for body, want, vals in ((raw[4 : len(raw) // 2], size, values),
                             (raw[4:], size + 2, values),
                             (bytes(flipped[4:]), size, values),
                             (raw[4:], size, (values[0], 7, *values[2:]))):
        errors = []
        for decode in (native.aec_decode, native.aec_decode_py):
            try:
                got = decode(body, vals, want)
            except OSError as err:
                errors.append(str(err))
            else:
                errors.append(hash(got))
        assert errors[0] == errors[1]
    with pytest.raises(OSError, match="at most"):
        native.szip_decode(raw, values, size - 1)


NO_NATIVE_READ = """
import hashlib, json, sys
from chromosight_torch import native
from chromosight_torch.io import hdf5
assert not native.filters_native() and native.get_lib() is None
digests = {}
with hdf5.File(sys.argv[1]) as f:
    for group in ("pixels", "bins", "indexes", "chroms"):
        for name in f[group].keys():
            data = f[f"{group}/{name}"][()]
            digests[f"{group}/{name}"] = hashlib.sha256(data.tobytes()).hexdigest()
    print(json.dumps({"digests": digests, "szip": f.walked["szip chunk"]}))
"""


@pytest.mark.parametrize("path", SZIP_FIXTURES, ids=["nn", "shuffle_ec"])
def test_szip_fixture_reads_without_native_code(path):
    """Under CHROMOSIGHT_TPU_NO_NATIVE=1 (a subprocess: no native library,
    ``aec_decode_py`` and the numpy unshuffle) every dataset of the szip
    fixture reads to the bytes the native read gives."""
    import hashlib

    env = dict(os.environ, CHROMOSIGHT_TPU_NO_NATIVE="1", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", NO_NATIVE_READ, str(path)], env=env,
                         capture_output=True, text=True, check=True, timeout=300)
    got = json.loads(out.stdout)
    assert got["szip"] >= 15
    with hdf5.File(path) as f:
        for name, digest in got["digests"].items():
            assert hashlib.sha256(f[name][()].tobytes()).hexdigest() == digest, name
        assert len(got["digests"]) == 11


# -- the port's szip writer ------------------------------------------------ #

def writer_arrays(rng):
    enum = hdf5.enum_dtype({"chr1": 0, "chr2": 1, "chrM": 2})
    return {"pixels/bin2_id": np.sort(rng.randint(0, 1 << 40, 50_000)).astype(np.int64),
            "pixels/count": rng.poisson(3, 50_000).astype(np.int32),
            "bins/chrom": rng.randint(0, 3, 720).astype(np.int32).view(enum),
            "bins/weight": rng.rand(777), "u1": rng.randint(0, 255, 3_000).astype(np.uint8),
            "be": rng.randint(-900, 900, 3_001).astype(">i2"),
            "random": rng.randint(0, 1 << 62, 2_000).astype(np.int64),
            "f4": rng.rand(300, 7).astype(np.float32),
            "names": np.array([b"chr1", b"chr22"], "S32"), "tiny": np.arange(5, dtype=np.int32)}


WRITER_CHUNKS = {"pixels/bin2_id": 6_094, "pixels/count": 1_000, "bins/chrom": 256,
                 "bins/weight": 700, "u1": 37, "be": 1_000, "random": 100, "f4": 50,
                 "names": 2, "tiny": 5}


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_h5py_reads_the_szip_writer(tmp_path, monkeypatch, libver):
    """``hdf5.write(..., compression="szip")``: h5py reads every dataset
    equal to its array, shuffle + szip with the client values h5py's own
    ``compression="szip", shuffle=True`` stores for that column and chunk
    (gzip where HDF5 refuses szip: fixed strings, chunks under 8
    elements), chunks szip does not shrink stored shuffled with their
    filter-mask bit set as h5py stores them; the port reads it back, and
    the bytes do not depend on the thread count."""
    arrays = writer_arrays(np.random.RandomState(11))
    paths = []
    for threads in (1, 4):
        monkeypatch.setattr(hdf5, "THREADS", threads)
        paths.append(tmp_path / f"{threads}.h5")
        hdf5.write(paths[-1], arrays, {"format": "test"}, chunks=WRITER_CHUNKS, libver=libver,
                   compression="szip")
    assert paths[0].read_bytes() == paths[1].read_bytes()
    with h5py.File(paths[0], "r") as f, h5py.File(tmp_path / "h5py.h5", "w") as ref:
        for name, array in arrays.items():
            d = f[name]
            assert d.dtype == np.dtype(array.dtype.str) and d[()].tobytes() == array.tobytes()
            if name in ("names", "tiny"):
                assert (d.compression, d.shuffle) == ("gzip", True), name
                continue
            theirs = ref.create_dataset(name, data=array, chunks=d.chunks,
                                        maxshape=d.maxshape, compression="szip", shuffle=True)
            plist, their_plist = d.id.get_create_plist(), theirs.id.get_create_plist()
            assert [plist.get_filter(i) for i in range(plist.get_nfilters())] == [
                their_plist.get_filter(i) for i in range(their_plist.get_nfilters())], name
            masks = [d.id.get_chunk_info(i).filter_mask for i in range(d.id.get_num_chunks())]
            their_masks = [theirs.id.get_chunk_info(i).filter_mask
                           for i in range(theirs.id.get_num_chunks())]
            assert masks == their_masks, name
            for lo, hi in boundary_slices(len(array), d.chunks[0])[:4]:
                assert d[lo:hi].tobytes() == array[lo:hi].tobytes(), (name, lo, hi)
        assert set(masks) == {0} and set(f["random"].id.get_chunk_info(i).filter_mask
                                         for i in range(20)) == {2}
    with hdf5.File(paths[0]) as ours:
        for name, array in arrays.items():
            assert ours[name][()].tobytes() == array.tobytes(), name
        assert ours.walked["szip chunk"] > 50
    assert_reads_like_h5py(paths[0])


def test_szip_writer_needs_the_native_library(tmp_path, monkeypatch):
    """Without ``aec.cpp`` (no compiler, or CHROMOSIGHT_TPU_NO_NATIVE) the
    szip writer raises; gzip writes as before."""
    monkeypatch.setattr(native, "_filter_lib", lambda src: None)
    with pytest.raises(RuntimeError, match="aec.cpp"):
        hdf5.write(tmp_path / "x.h5", {"x": np.arange(100)}, chunks={"x": 10},
                   compression="szip")
    hdf5.write(tmp_path / "y.h5", {"x": np.arange(100)}, chunks={"x": 10})
    with pytest.raises(ValueError):
        hdf5.write(tmp_path / "z.h5", {"x": np.arange(100)}, compression="lzf")


def test_szip_cooler_layout_reads_like_the_example(tmp_path):
    """``write_cooler_layout(..., compression="szip")`` of data_test/
    example.cool as an .mcool resolution: h5py reads the tables equal to
    the example's (int64 ids, an enum chrom), szip on every pixel and
    bins column, and the port's loops table from it is byte for byte the
    one from example.cool."""
    src = CoolSource(str(EXAMPLE_COOL))
    b1, b2, ct = src._pixels(0, src.nnz)
    path = tmp_path / "szip.mcool"
    write_cooler_layout(path, bins_frame(src), {"bin1_id": b1, "bin2_id": b2, "count": ct},
                        group="/resolutions/1000", compression="szip")
    with h5py.File(path, "r") as f, h5py.File(EXAMPLE_COOL, "r") as ref:
        g = f["resolutions/1000"]
        for col in ("pixels/bin1_id", "pixels/bin2_id", "pixels/count", "bins/start",
                    "bins/chrom", "bins/weight", "indexes/bin1_offset"):
            assert (g[col].compression, g[col].shuffle) == ("szip", True), col
            assert np.array_equal(g[col][()], ref[col][()], equal_nan=True), col
        assert g["pixels/bin1_id"].dtype == np.int64
    for uri, prefix in ((str(EXAMPLE_COOL), "example"), (f"{path}::/resolutions/1000", "szip")):
        with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
            assert main(["detect", "--no-plotting", uri, str(tmp_path / prefix)],
                        device="cpu") == 0
    assert (tmp_path / "szip.tsv").read_bytes() == (tmp_path / "example.tsv").read_bytes()


# -- the JAX package's calls from the szip fixtures ------------------------ #

@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("path", SZIP_FIXTURES, ids=["nn", "shuffle_ec"])
def test_jax_calls_from_the_szip_fixtures(tmp_path, path, run):
    """The JAX CLI through h5py against the port's CLI from each szip
    fixture (``assert_jax_calls``), the loops the example's 89."""
    assert_jax_calls(tmp_path, str(path), run)
    if run == "loops":
        assert len((tmp_path / "port.tsv").read_text().splitlines()) == 90


# -- script mode: the read against h5py's --------------------------------- #

PORT_READ = """
import sys, time
from chromosight_torch.io import hdf5
t0 = time.perf_counter()
with hdf5.File(sys.argv[1]) as f:
    n = f[sys.argv[2]][:].nbytes
print(time.perf_counter() - t0, n)
"""


def write_timing_file(path):
    """The timing file, written with h5py: the int64 ``bin2_id`` of
    ``synth_chrom(48000)`` (seed 0) cut to ``TIMING_ROWS``, chunked by
    ``TIMING_CHUNK`` rows, resizable, shuffle + szip ('nn', 8)."""
    from chromosight_torch.io.source import synth_chrom

    _, cols, _, _ = synth_chrom(48_000, np.random.RandomState(0))
    with h5py.File(path, "w") as f:
        f.create_dataset("pixels/bin2_id", data=cols[:TIMING_ROWS].astype(np.int64),
                         chunks=(TIMING_CHUNK,), maxshape=(None,), compression="szip",
                         shuffle=True)


def time_reads(path, trees, repeats=3):
    """Seconds of h5py's read of the column of ``path`` whole, and of the
    port's read from each checkout in ``trees`` (a subprocess with that
    checkout first on ``PYTHONPATH``), in turns: h5py, the trees, then the
    trees reversed, ``repeats`` times; the median of each."""
    seconds = {"h5py": []}
    seconds.update({tree: [] for tree in trees})
    for _ in range(repeats):
        for tree in ["h5py", *trees, *reversed(trees)]:
            if tree == "h5py":
                t0 = time.perf_counter()
                with h5py.File(path, "r") as f:
                    f["pixels/bin2_id"][:]
                seconds["h5py"].append(time.perf_counter() - t0)
                continue
            env = dict(os.environ, PYTHONPATH=str(tree))
            out = subprocess.run([sys.executable, "-c", PORT_READ, str(path), "pixels/bin2_id"],
                                 env=env, capture_output=True, text=True, check=True, cwd=tree)
            seconds[tree].append(float(out.stdout.split()[0]))
    return {k: (statistics.median(v), v) for k, v in seconds.items()}


def time_codecs(path):
    """On the timing file's bin2_id and the matching count column: the
    port's write (``hdf5.write``, ``THREADS`` threads) and read of both
    columns with gzip and with szip (seconds, bytes), and ``aec.cpp``'s
    encoder and decoder on one thread (MB/s of pixels, best of three)."""
    from chromosight_torch.io.source import synth_chrom

    _, cols, vals, _ = synth_chrom(48_000, np.random.RandomState(0))
    columns = {"pixels/bin2_id": cols[:TIMING_ROWS].astype(np.int64),
               "pixels/count": vals[:TIMING_ROWS].astype(np.int32)}
    chunks = {"pixels/bin2_id": TIMING_CHUNK, "pixels/count": 2 * TIMING_CHUNK}
    for compression in ("gzip", "szip"):
        out = f"{path}.{compression}.h5"
        t0 = time.perf_counter()
        hdf5.write(out, columns, chunks=chunks, compression=compression)
        wrote = time.perf_counter() - t0
        t0 = time.perf_counter()
        with hdf5.File(out) as f:
            n = sum(f[name][:].nbytes for name in columns)
        read = time.perf_counter() - t0
        print(f"port {compression}: wrote {os.path.getsize(out)} bytes in {wrote:.3f} s, read "
              f"{n} bytes in {read:.3f} s ({n / read / 1e9:.2f} GB/s)")
        os.unlink(out)
    for name, column in columns.items():
        rows = chunks[name]
        flat = column[: len(column) // rows * rows][: 400 * rows].view(np.uint8)
        size, element = rows * column.itemsize, column.itemsize
        values = hdf5.szip_values(column.dtype, (rows,))
        best = {"encode": 1e9, "decode": 1e9}
        for _ in range(3):
            t0 = time.perf_counter()
            coded = native.szip_encode_chunks(flat, size, values, element, 1)
            best["encode"] = min(best["encode"], time.perf_counter() - t0)
            lengths = np.array([len(data) for data, _ in coded])
            buf = np.frombuffer(b"".join(data for data, _ in coded), np.uint8)
            out = np.empty(len(flat), np.uint8)
            t0 = time.perf_counter()
            assert native.szip_chunks(buf, np.r_[0, np.cumsum(lengths)[:-1]], lengths, out,
                                      np.arange(len(coded)) * size, size, values, element, 1)
            best["decode"] = min(best["decode"], time.perf_counter() - t0)
            assert out.tobytes() == flat.tobytes()
        print(f"aec.cpp on one thread, {name} ({len(coded)} chunks of {rows} rows): " + ", ".join(
            f"{k} {len(flat) / v / 1e6:.0f} MB/s" for k, v in best.items()))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Time the port's read of a 24,000,000-row "
                                     "shuffle + szip column against h5py's, on this host, and "
                                     "the port's gzip and szip writes and reads (time_codecs).")
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
    print(f"{args.path}: {os.path.getsize(args.path)} bytes; {cpu}, {os.cpu_count()} cores, "
          f"{hdf5.THREADS} reader threads")
    for name, (median, runs) in time_reads(args.path, args.trees).items():
        print(f"{name}: median {median:.3f} s of {', '.join(f'{t:.3f}' for t in runs)}")
    time_codecs(args.path)
