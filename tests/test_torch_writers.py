"""The port's JSON window writer against ``json.dump``: the native
formatter (``native/jsonwin.cpp``) writes ``json.dump({i:
window.tolist()}, indent=4)``'s bytes for every float stack, whatever its
dtype, layout, shape or values; anything else, or a stack without the
native library, goes through ``json.dump`` itself; the counters say which
path ran and how many bytes it wrote; the JAX package's writer gives the
same bytes."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import chromosight_torch.io.writers as t_writers
import chromosight_torch.native as t_native
import chromosight_torch.observability as t_obs
import chromosight_tpu.io.writers as j_writers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_WINDOWS = os.path.join(ROOT, "tests", "data", "golden_detect_loops.json")

EDGES = [
    np.nan, np.inf, 0.0, 5e-324, 2.2250738585072014e-308, 1e-5, 1e-4,
    9.999999999999999e-5, 1e16, 9999999999999998.0, 1234567890123456.0, 1e22, 1e300,
    0.1, 1 / 3, 1.0, 2.0, 10.0, 100.0, 12345.0, 1e15, 123456789.0, 1.5e16, 1.7976931348623157e308,
    1e-323, 0.001, 0.0001234, 1e-7, 123.456, 2.5, 0.5, 1e21, 4.35e-4,
]


def _edges():
    """The edge values, their negatives and their neighbours, in windows of
    3 x 7 (NaN padding)."""
    vals = np.array(EDGES)
    vals = np.concatenate([vals, -vals])
    finite = vals[np.isfinite(vals)]
    with np.errstate(over="ignore"):
        vals = np.concatenate([vals, np.nextafter(finite, np.inf), np.nextafter(finite, -np.inf)])
    out = np.full(-(-len(vals) // 21) * 21, np.nan)
    out[: len(vals)] = vals
    return out.reshape(-1, 3, 7)


def _random_bits(n=100_000, seed=0):
    """``n`` finite doubles drawn as bit patterns: every exponent alike."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**64, size=2 * n, dtype=np.uint64).view(np.float64)
    vals = bits[np.isfinite(bits)][:n]
    assert len(vals) == n
    return vals.reshape(-1, 20, 50)


def _short_decimals(seed=1):
    """Few-digit decimals at every scale, where the shortest digits are
    short and a nearest-or-shortest slip would show."""
    rng = np.random.default_rng(seed)
    mant = rng.integers(-10**6, 10**6, size=400 * 17 * 17).astype(np.float64)
    return (mant * 10.0 ** rng.integers(-30, 30, size=mant.size)).reshape(400, 17, 17)


def _golden():
    with open(GOLDEN_WINDOWS) as fh:
        wins = json.load(fh)
    return np.array([wins[str(i)] for i in range(len(wins))])


def _normal(shape, seed=2, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _half():
    wins = _normal((6, 5, 5), dtype=np.float16) * np.float16(100)
    wins[0, 0, :3] = [np.nan, np.inf, -np.inf]
    return wins


CASES = {
    "edges": _edges,
    "random_bits": _random_bits,
    "short_decimals": _short_decimals,
    "golden_loops": _golden,
    "empty_stack": lambda: np.empty((0, 17, 17)),
    "one_value": lambda: np.array([[[0.25]]]),
    "square_17": lambda: _normal((5, 17, 17)),
    "non_square_3x7": lambda: _normal((4, 3, 7)),
    "no_rows": lambda: np.empty((2, 0, 5)),
    "no_columns": lambda: np.empty((2, 3, 0)),
    "across_blocks": lambda: _normal((1900, 17, 17)) * 1e3,
    "float32": lambda: _normal((7, 17, 17), dtype=np.float32),
    "float16": _half,
    "non_contiguous": lambda: _normal((10, 17, 34))[::2, ::-1, ::2],
    "big_endian": lambda: _normal((3, 4, 4)).astype(">f8"),
}


def _json_dump(windows, path):
    with open(path, "w") as handle:
        json.dump({i: w.tolist() for i, w in enumerate(windows)}, handle, indent=4)
    with open(path, "rb") as handle:
        return handle.read()


def _save(windows, prefix):
    t_writers.save_windows(windows, prefix, fmt="json")
    with open(prefix + ".json", "rb") as handle:
        return handle.read()


@pytest.fixture
def native_lib():
    if t_native._filter_lib(t_native._JSONWIN_SRC) is None:
        pytest.skip("jsonwin.cpp could not be built here (g++ missing or "
                    "CHROMOSIGHT_TPU_NO_NATIVE set)")


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_windows_json_bytes(case, tmp_path, native_lib):
    """Byte for byte ``json.dump(indent=4)``, through the native path."""
    windows = CASES[case]()
    t_obs.reset()
    got = _save(windows, str(tmp_path / "port"))
    assert got == _json_dump(windows, tmp_path / "ref.json")
    assert t_obs.counters().get("write: windows native") == len(windows)
    assert "write: windows fallback" not in t_obs.counters()


def test_save_windows_small_blocks(tmp_path, monkeypatch, native_lib):
    """Blocks of a few windows each, split unevenly over the threads."""
    monkeypatch.setattr(t_writers, "JSON_BLOCK_VALUES", 5 * 3 * 7)
    windows = _edges()
    windows = np.concatenate([windows] * 6)
    assert len(windows) > 5 * t_writers.THREADS
    assert _save(windows, str(tmp_path / "port")) == _json_dump(windows, tmp_path / "ref.json")


@pytest.mark.parametrize("threads", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("block", [1, 7, 1000])
def test_json_windows_threads_and_blocks(threads, block, tmp_path, native_lib):
    """The bytes depend on neither the thread count nor the block size."""
    windows = np.ascontiguousarray(_short_decimals()[:23, :4])
    path = tmp_path / "w.json"
    nbytes = t_native.json_windows(str(path), windows, block, threads)
    got = path.read_bytes()
    assert nbytes == len(got)
    assert got == _json_dump(windows, tmp_path / "ref.json")


@pytest.mark.parametrize("case", ["int64", "bool", "ragged_list", "two_dimensional",
                                  "float_no_native"])
def test_save_windows_json_fallback(case, tmp_path, monkeypatch):
    """What the formatter does not take, and any stack without its
    library, goes through ``json.dump``: the same bytes, counted as the
    fallback."""
    windows = {
        "int64": lambda: np.arange(2 * 3 * 4).reshape(2, 3, 4),
        "bool": lambda: np.eye(3, dtype=bool)[None].repeat(2, axis=0),
        "ragged_list": lambda: [np.zeros((2, 2)), np.ones((3, 1))],
        "two_dimensional": lambda: _normal((3, 5)),
        "float_no_native": _edges,
    }[case]()
    if case == "float_no_native":
        monkeypatch.setitem(t_native._FILTER_LIBS, "jsonwin", None)
    t_obs.reset()
    got = _save(windows, str(tmp_path / "port"))
    assert got == _json_dump(windows, tmp_path / "ref.json")
    counts = t_obs.counters()
    assert counts.get("write: windows fallback") == len(windows)
    assert "write: windows native" not in counts
    assert counts.get("write: window bytes") == len(got)


def test_save_windows_bytes_counter(tmp_path, native_lib):
    """``write: window bytes`` adds each file's size."""
    t_obs.reset()
    first = _save(_normal((3, 17, 17)), str(tmp_path / "a"))
    second = _save(_normal((4, 5, 5), seed=3), str(tmp_path / "b"))
    counts = t_obs.counters()
    assert counts["write: windows native"] == 7
    assert counts["write: window bytes"] == len(first) + len(second)


@pytest.mark.parametrize("case", ["golden_loops", "edges", "float32", "empty_stack"])
def test_save_windows_matches_jax_writer(case, tmp_path):
    """The JAX package's ``save_windows`` writes the same file."""
    windows = CASES[case]()
    j_writers.save_windows(windows, str(tmp_path / "jax"), fmt="json")
    assert _save(windows, str(tmp_path / "port")) == (tmp_path / "jax.json").read_bytes()


def test_save_windows_missing_directory(tmp_path, native_lib):
    """A file that cannot be opened raises the OSError ``open`` raises."""
    prefix = str(tmp_path / "missing" / "out")
    with pytest.raises(FileNotFoundError):
        t_writers.save_windows(_normal((2, 3, 3)), prefix)


def test_save_windows_no_native_env(tmp_path):
    """Under CHROMOSIGHT_TPU_NO_NATIVE=1 the writer takes ``json.dump``
    and writes the same bytes."""
    windows = _edges()
    np.save(tmp_path / "wins.npy", windows)
    code = (
        "import numpy as np, sys\n"
        "from chromosight_torch import native, observability\n"
        "from chromosight_torch.io.writers import save_windows\n"
        "save_windows(np.load(sys.argv[1]), sys.argv[2])\n"
        "assert native._filter_lib(native._JSONWIN_SRC) is None\n"
        "assert observability.counters()['write: windows fallback'] == len(np.load(sys.argv[1]))\n"
    )
    env = dict(os.environ, CHROMOSIGHT_TPU_NO_NATIVE="1", PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "wins.npy"),
                    str(tmp_path / "port")], check=True, env=env, timeout=300)
    got = (tmp_path / "port.json").read_bytes()
    assert got == _json_dump(windows, tmp_path / "ref.json")
