"""The port's HDF5 writer (``chromosight_torch.io.hdf5`` and
``hdf5_write``) against h5py, which is the oracle here and nowhere in the
port:

* ``File.write_dataset`` and ``File.unlink`` into every shape of group
  h5py makes: symbol-table groups of one leaf node, a full leaf and a
  two-level B-tree; compact new-style groups at 7 and 8 links (the 9th
  turns the group dense); dense groups with and without tracked creation
  order, up to a link heap of many direct blocks; new-style groups in a
  version-1 object header.  h5py reads the keys in its order, the data
  and the attributes after each write, and writes into the file again.
* The dense link storage the port writes (fractal heap, free-space
  manager, v2 B-trees of records of types 5 and 6) field for field what
  h5py writes for the same links.
* ``ice_balance(..., store=True)`` in each shape stores the weights it
  stores into the plain file, bit for bit.
* ``hdf5.write(..., libver="latest")``: superblock 3, version-2 object
  headers, the chunk index h5py picks for each dataset (extensible array,
  fixed array, single chunk) and the structures walked beside those of
  h5py's own file of the same columns; extensible arrays of 3 to 140,000
  chunks held to h5py's header statistics; ``detect`` at ``--norm
  auto`` from a weightless newest-layout file with an 8-link bins group
  (turned dense by the stored weights) gives the loops golden, through
  the port's CLI and the JAX package's.
"""

import contextlib
import io
import pathlib
import shutil
import struct

import numpy as np
import pandas as pd
import pytest

h5py = pytest.importorskip("h5py")

from chromosight_torch.cli.main import main  # noqa: E402
from chromosight_torch.io import hdf5  # noqa: E402
from chromosight_torch.io.cool import bins_frame, chunk_rows, write_cooler_layout  # noqa: E402
from chromosight_torch.io.source import CoolSource  # noqa: E402
from chromosight_torch.ops.balance import ice_balance  # noqa: E402
from test_torch_hdf5 import assert_same  # noqa: E402
from test_torch_hdf5_formats import (  # noqa: E402
    COOLER_OPTS,
    assert_reads_like_h5py,
    example_columns,
)
from torch_parity import torch_one_thread  # noqa: E402, F401

ROOT = pathlib.Path(__file__).parents[1]
DATA = ROOT / "tests" / "data"
EXAMPLE_COOL = ROOT / "data_test" / "example.cool"
NORM_COLUMNS = ("KR", "VC", "VC_SQRT", "GW_KR", "GW_VC")


def new_style_v1(f, name):
    """A group that tracks creation order (a new-style group) in a
    version-1 object header, as h5py makes it at libver "earliest"."""
    gcpl = h5py.h5p.create(h5py.h5p.GROUP_CREATE)
    gcpl.set_link_creation_order(h5py.h5p.CRT_ORDER_TRACKED)
    h5py.h5g.create(f.id, name.encode(), gcpl=gcpl)
    return f[name]


# shape: (libver, links before the write, track_order, version-1 header)
SHAPES = {
    "symbol_table_leaf": ("earliest", 3, False, False),
    "symbol_table_full_leaf": ("earliest", 8, False, False),
    "symbol_table_two_levels": ("earliest", 300, False, False),
    "compact_7": ("latest", 7, False, False),
    "compact_8": ("latest", 8, False, False),
    "compact_8_track_order": ("latest", 8, True, False),
    "dense": ("latest", 12, False, False),
    "dense_track_order": ("latest", 12, True, False),
    "dense_many_blocks": ("latest", 2000, False, False),
    "v1_header_compact": ("earliest", 3, True, True),
    "v1_header_dense": ("earliest", 12, True, True),
}


def make_group(path, shape, columns=None):
    """A file whose group "bins" has the shape ``shape`` of ``SHAPES``:
    its links ``columns`` ({name: array}) or c000, c001, ..."""
    libver, n, track, v1 = SHAPES[shape]
    columns = columns or {f"c{i:03d}": np.arange(3) + i for i in range(n)}
    with h5py.File(path, "w", libver=libver) as f:
        group = new_style_v1(f, "bins") if v1 else f.create_group("bins", track_order=track)
        for name, value in columns.items():
            group[name] = value
    return list(columns)


def expected_keys(shape, names):
    return names if SHAPES[shape][2] else sorted(names, key=lambda n: n.encode("utf-8"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_store_links_into_every_group_shape(tmp_path, shape):
    """Add, replace and unlink ``bins/weight``: after each write h5py
    lists the group's links in its order (by name, or by creation order:
    a replaced link last, as h5py's ``del`` and create order it), reads
    every dataset and attribute, and the port reads the file as h5py
    does; then h5py adds, deletes and replaces links in the port's file."""
    path = tmp_path / "g.h5"
    names = make_group(path, shape)
    for step, value in (("add", 1.5), ("replace", 2.5), ("unlink", None)):
        with hdf5.File(path, "r+") as f:
            if value is None:
                f.unlink("bins/weight")
            else:
                f.write_dataset("bins/weight", np.full(5, value), {"step": step, "n": 3})
        want = expected_keys(shape, names + ([] if value is None else ["weight"]))
        with h5py.File(path, "r") as f:
            assert list(f["bins"]) == want, step
            if value is not None:
                assert f["bins/weight"][()].tolist() == [value] * 5
                assert_same(dict(f["bins/weight"].attrs), {"n": np.int64(3), "step": step}, step)
            for i, name in enumerate(names):
                assert f[f"bins/{name}"][()].tolist() == list(range(i, i + 3)), name
        assert_reads_like_h5py(path)
    with hdf5.File(path) as f:
        group = f["bins"]
        if SHAPES[shape][0] == "earliest" and not SHAPES[shape][2]:
            level = f._btree(group.btree, 8)[0]
            assert level == (1 if len(names) > 256 else 0)
        else:
            assert group.dense == (len(names) >= 8)
            assert (f._read(group.addr, 4) == b"OHDR") == (not SHAPES[shape][3])
    with h5py.File(path, "r+") as f:
        f["bins/again"] = np.arange(4)
        del f[f"bins/{names[0]}"]
        f["bins/weight"] = np.arange(2.0)
    with h5py.File(path, "r") as f:
        assert list(f["bins"]) == expected_keys(shape, names[1:] + ["again", "weight"])
    assert_reads_like_h5py(path)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_store_links_into_the_root_group(tmp_path, libver):
    """A link added to and removed from the root group (a symbol-table root
    whose B-tree address the superblock caches, or a new-style root):
    h5py reads the file, opens it for writing (checking the cached
    address) and writes to it again."""
    path = tmp_path / "root.h5"
    with h5py.File(path, "w", libver=libver) as f:
        for i in range(9):
            f[f"c{i}"] = np.arange(3) + i
    with hdf5.File(path, "r+") as f:
        f.write_dataset("weight", np.arange(4.0))
        f.unlink("c0")
    with h5py.File(path, "r+") as f:
        assert sorted(f) == sorted([f"c{i}" for i in range(1, 9)] + ["weight"])
        assert f["weight"][()].tolist() == [0.0, 1.0, 2.0, 3.0]
        f["again"] = np.arange(2)
    assert_reads_like_h5py(path)


def structure_fields(path):
    """The fields of the dense link storage of ``bins`` that do not hold
    addresses: the fractal heap's header, its free-space manager's header,
    the v2 B-trees' headers."""
    raw = pathlib.Path(path).read_bytes()
    with hdf5.File(path) as f:
        _, _, heap, names, orders = f["bins"].link_info
    names_fields = ["id_len", "filters", "flags", "max_managed", "next_huge", "huge_btree",
                    "free", "free_space_manager", "managed_space", "allocated", "iterator",
                    "objects", "huge_size", "huge", "tiny_size", "tiny", "width",
                    "start_block", "max_direct", "max_bits", "start_rows", "root", "rows"]
    values = struct.unpack_from("<HHBIQQQQQQQQQQQQHQQHHQH", raw, heap + 5)
    fields = dict(zip(names_fields, values))
    fsm = fields.pop("free_space_manager")
    fields.pop("root")
    # FSHD: client, space, sections, serialized, ghost, classes, shrink,
    # expand, address bits, largest section (no address)
    fields["FSHD"] = raw[fsm + 5 : fsm + 5 + 1 + 4 * 8 + 8 + 8]
    fields["BTHD 5"] = raw[names + 4 : names + 16]
    fields["BTHD 6"] = raw[orders + 4 : orders + 16] if orders is not None else None
    return fields


@pytest.mark.parametrize("track_order", [False, True], ids=["by_name", "by_creation"])
def test_dense_storage_like_h5pys(tmp_path, track_order):
    """A 9th link into a compact group of 8 (cooler's bins with five
    normalisation vectors): the port's dense storage holds the fields
    h5py's holds after h5py adds the same link (heap ID widths, free
    space, object count, block sizes, the free-space manager's
    statistics, B-tree node and record sizes and record counts)."""
    columns = {name: np.arange(3.0) for name in ("chrom", "start", "end", *NORM_COLUMNS)}
    ours, ref = tmp_path / "ours.h5", tmp_path / "ref.h5"
    for path in (ours, ref):
        make_group(path, "compact_8_track_order" if track_order else "compact_8", columns)
    with hdf5.File(ours, "r+") as f:
        f.write_dataset("bins/weight", np.arange(3.0))
    with h5py.File(ref, "r+") as f:
        f["bins/weight"] = np.arange(3.0)
    assert structure_fields(ours) == structure_fields(ref)
    with h5py.File(ours, "r") as f, h5py.File(ref, "r") as g:
        assert list(f["bins"]) == list(g["bins"])


def cool_in_shape(path, shape, columns, attrs):
    """``columns`` ({path: array} of example.cool without its weights) in
    one file, the bins group in ``shape`` (more normalisation-like columns
    where the shape needs links)."""
    libver, n, track, v1 = SHAPES[shape]
    bins = {k.split("/")[1]: v for k, v in columns.items() if k.startswith("bins/")}
    for i in range(max(0, min(n, 300) - len(bins))):
        bins[f"norm{i:03d}"] = np.full(720, float(i))
    with h5py.File(path, "w", libver=libver) as f:
        for key, value in attrs.items():
            f.attrs[key] = value
        group = new_style_v1(f, "bins") if v1 else f.create_group("bins", track_order=track)
        for name, value in bins.items():
            group[name] = value
        for name, value in columns.items():
            if not name.startswith("bins/"):
                f[name] = value


@pytest.mark.parametrize("shape", sorted(set(SHAPES) - {"dense_many_blocks"}))
def test_ice_stores_weights_into_every_group_shape(tmp_path, shape):
    """``ice_balance(..., store=True)`` on example.cool's tables with the
    bins group in each shape stores bit for bit the weights it stores into
    the plain file; h5py reads them."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    columns.pop("bins/weight")
    plain, shaped = tmp_path / "plain.cool", tmp_path / "shaped.cool"
    cool_in_shape(plain, "symbol_table_leaf", columns, attrs)
    cool_in_shape(shaped, shape, columns, attrs)
    with contextlib.redirect_stderr(io.StringIO()):
        want = ice_balance(CoolSource(str(plain)), store=True)
        got = ice_balance(CoolSource(str(shaped)), store=True)
    assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    with h5py.File(shaped, "r") as f, h5py.File(plain, "r") as g:
        assert f["bins/weight"][()].tobytes() == g["bins/weight"][()].tobytes()
        assert_same(dict(f["bins/weight"].attrs), dict(g["bins/weight"].attrs), "stats")
    assert CoolSource(str(shaped)).weights.tobytes() == np.asarray(want).tobytes()


def h5py_latest(path, datasets, chunks, fixed, root_attrs):
    """``datasets`` written by h5py at libver "latest" with the chunks,
    filters and maximum shapes of ``hdf5.write``'s cooler layout."""
    with h5py.File(path, "w", libver="latest") as f:
        for key, value in root_attrs.items():
            f.attrs[key] = value
        for name, value in datasets.items():
            maxshape = value.shape if name in fixed else (None, *value.shape[1:])
            f.create_dataset(name, data=value, chunks=(chunks[name], *value.shape[1:]),
                             maxshape=maxshape, **COOLER_OPTS)


INDEX_SIGNATURES = ("superblock v3", "OHDR", "chunk index 1", "chunk index 3", "chunk index 4",
                    "EAHD", "EAIB", "EASB", "EADB", "FAHD", "FADB", "FADB page", "BTHD type 8")


def test_write_latest_like_h5py(tmp_path):
    """``write_cooler_layout(..., libver="latest")`` of example.cool's
    tables with five normalisation vectors: h5py reads every object as the
    port wrote it (superblock 3, version-2 object headers, pixel columns
    through extensible arrays, the other columns of fixed size through a
    single chunk or a fixed array, the bins group compact at 8 links, 13
    root attributes dense), and the port's reader walks the structures it
    walks in h5py's own file of the same columns and chunks."""
    columns, attrs = example_columns(EXAMPLE_COOL)
    source = CoolSource(str(EXAMPLE_COOL))
    rng = np.random.RandomState(0)
    norms = {name: rng.rand(720) for name in NORM_COLUMNS}
    ours, ref = tmp_path / "ours.cool", tmp_path / "ref.cool"
    bins = bins_frame(source).drop(columns="weight")
    b1, b2, ct = source._pixels(0, source.nnz)
    write_cooler_layout(str(ours), bins, {"bin1_id": b1, "bin2_id": b2, "count": ct},
                        columns=norms, libver="latest", pixel_rows=25_000)
    with h5py.File(ours, "r") as f:
        datasets, chunks = {}, {}
        f.visititems(lambda n, o: datasets.__setitem__(n, o[()])
                     if isinstance(o, h5py.Dataset) else None)
        for name in datasets:
            chunks[name] = f[name].chunks[0]
        fixed = {n for n in datasets if f[n].maxshape == f[n].shape}
        root_attrs = dict(f.attrs)
        assert len(f["bins"]) == 8 and f["pixels/count"].maxshape == (None,)
        assert fixed == {n for n in datasets if not n.startswith("pixels/")}
        assert f["bins/chrom"].dtype == h5py.enum_dtype({"chr1": 0, "chr2": 1, "chr3": 2},
                                                        basetype="<i4")
    h5py_latest(ref, datasets, chunks, fixed, root_attrs)
    walked = {path: assert_reads_like_h5py(path) for path in (ours, ref)}
    for signature in INDEX_SIGNATURES:
        assert walked[ours][signature] == walked[ref][signature], signature
    assert walked[ours]["EAHD"] == 3 and walked[ours]["object header v1"] == 0
    with hdf5.File(ours) as f, hdf5.File(ref) as g:
        for name in datasets:
            assert f[name]._index_type == g[name]._index_type, name
        assert not f["bins"].dense
    for name, value in columns.items():
        if name != "bins/weight":
            assert datasets[name].tobytes() == value.tobytes(), name


@pytest.mark.parametrize("n_chunks", [3, 200, 3000, 140_000])
def test_extensible_array_like_h5pys(tmp_path, n_chunks):
    """The extensible array of a column of ``n_chunks`` chunks (index
    block, its data blocks, super blocks, paged data blocks): the port's
    header statistics (super and data blocks created and their bytes, the
    largest index set, elements realized) and element width are h5py's,
    and the reader walks as many structures of each kind in both."""
    data = np.random.RandomState(n_chunks).randint(0, 9, n_chunks).astype(np.uint8)
    ours, ref = tmp_path / "ours.h5", tmp_path / "ref.h5"
    hdf5.write(ours, {"x": data}, chunks={"x": 1}, libver="latest")
    h5py_latest(ref, {"x": data}, {"x": 1}, set(), {})
    heads = []
    for path in (ours, ref):
        with hdf5.File(path) as f:
            addr = f["x"]._index_addr
            heads.append(f._read(addr + 4, 8 + 6 * 8))
            assert f["x"][()].tobytes() == data.tobytes()
            f["x"]._chunk_index()
            heads.append({k: v for k, v in f.walked.items() if k.startswith("EA")})
    assert heads[0] == heads[2] and heads[1] == heads[3]
    with h5py.File(ours, "r") as f:
        assert f["x"][()].tobytes() == data.tobytes()


def run_quiet(fn, args):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        return fn(args)


def test_detect_from_a_weightless_latest_file(tmp_path):
    """``detect`` at ``--norm auto`` from a weightless newest-layout file
    whose bins group holds chrom, start, end and five normalisation
    vectors (8 links): ICE stores the weights, the ninth link turns the
    group dense, and the calls are tests/data/golden_detect_loops.tsv's;
    the JAX package's CLI (h5py storing the weights into a copy) gives the
    same calls, its scores and p-values within 5e-5 and 1e-5 of the
    port's, and the same weights bit for bit."""
    from chromosight_tpu.cli.main import main as jax_main

    source = CoolSource(str(EXAMPLE_COOL))
    rng = np.random.RandomState(1)
    path = tmp_path / "latest.cool"
    b1, b2, ct = source._pixels(0, source.nnz)
    write_cooler_layout(str(path), bins_frame(source).drop(columns="weight"),
                        {"bin1_id": b1, "bin2_id": b2, "count": ct},
                        columns={name: rng.rand(720) for name in NORM_COLUMNS},
                        libver="latest", pixel_rows=chunk_rows(source.nnz, 8) * 4)
    copy = tmp_path / "jax.cool"
    shutil.copy(path, copy)
    assert run_quiet(lambda a: main(a, device="cpu"),
                     ["detect", "--no-plotting", str(path), str(tmp_path / "port")]) == 0
    assert run_quiet(jax_main, ["detect", "--no-plotting", str(copy),
                                str(tmp_path / "jax")]) in (0, None)
    golden = pd.read_csv(DATA / "golden_detect_loops.tsv", sep="\t")
    key = ["bin1", "bin2", "kernel_id", "iteration"]
    tables = {prefix: pd.read_csv(tmp_path / f"{prefix}.tsv", sep="\t")
              for prefix in ("port", "jax")}
    for prefix, table in tables.items():
        assert len(table) == len(golden) == 89 and table[key].equals(golden[key]), prefix
    # ICE's weights, not the golden's stored ones: the two CLIs held to
    # each other at tests/test_golden_outputs.py's bounds
    for col, tol in (("score", 5e-5), ("pvalue", 1e-5)):
        assert np.abs(tables["port"][col] - tables["jax"][col]).max() < tol, col
    with hdf5.File(path) as f:
        assert f["bins"].dense and f.walked["superblock v3"] == 1
    with h5py.File(path, "r") as f, h5py.File(copy, "r") as g:
        assert list(f["bins"]) == list(g["bins"]) == sorted(
            ["chrom", "start", "end", "weight", *NORM_COLUMNS])
        assert f["bins/weight"][()].tobytes() == g["bins/weight"][()].tobytes()
