"""Pattern-table and window writers without pandas.

Counterpart of ``chromosight_tpu/io/writers.py``.  A table is a dict of
equal-length numpy columns in output order.  ``write_patterns`` writes
the bytes pandas' ``to_csv(sep="\\t", index=None, float_format="%.10f")``
writes: a tab-joined header, integers without decimals, floats with ten
decimals, NaN as an empty field, one ``\\n``-terminated line per row.
``save_windows(..., fmt="json")`` writes the bytes
``json.dump({i: window.tolist()}, handle, indent=4)`` writes; a 3-D stack
of a float dtype is widened to float64 and formatted natively
(``native.json_windows``, on ``hdf5.THREADS`` threads), anything else,
or any stack without the native library, goes through ``json.dump``.
"""

from __future__ import annotations

import json
import shutil
import sys
from os.path import dirname, getsize, isdir

import numpy as np

from chromosight_torch import native, observability
from chromosight_torch.io.hdf5 import THREADS

# seconds a download may wait on the network before it fails
DOWNLOAD_TIMEOUT = 10
# values the native JSON formatter holds as text at a time (~15 MB)
JSON_BLOCK_VALUES = 1 << 19


def _format_column(values, dec):
    values = np.asarray(values)
    if values.dtype.kind == "f":
        fmt = f"%.{dec}f"
        return ["" if np.isnan(v) else fmt % v for v in values.tolist()]
    return [str(v) for v in values.tolist()]


def write_patterns(coords, output_prefix, dec=10):
    """Write the pattern table ``coords`` (a dict of columns or a
    DataFrame) to ``<prefix>.tsv`` (stage ``write: table``)."""
    with observability.stage("write: table"):
        names = list(coords)
        cols = [_format_column(coords[name], dec) for name in names]
        lines = ["\t".join(names)]
        lines += ["\t".join(row) for row in zip(*cols)]
        with open(output_prefix + ".tsv", "w") as handle:
            handle.write("\n".join(lines) + "\n")


def save_windows(windows, output_prefix, fmt="json"):
    """Save the 3-D stack of windows around detected patterns (stage
    ``write: windows``)."""
    if fmt not in ("npy", "json"):
        raise ValueError("window format must be either npy or json.")
    with observability.stage("write: windows"):
        if fmt == "npy":
            np.save(output_prefix + ".npy", windows)
        else:
            _save_json(windows, output_prefix + ".json")


def _save_json(windows, path):
    """``json.dump({i: window.tolist()}, indent=4)``'s bytes at ``path``,
    counted as ``write: windows native`` or ``write: windows fallback``
    and ``write: window bytes``."""
    if (isinstance(windows, np.ndarray) and windows.ndim == 3
            and windows.dtype.kind == "f" and windows.dtype.itemsize <= 8):
        # float16 and float32 widen exactly: tolist() gives these doubles
        stack = np.ascontiguousarray(windows, dtype=np.float64)
        block = max(1, JSON_BLOCK_VALUES // max(1, stack.shape[1] * stack.shape[2]))
        nbytes = native.json_windows(path, stack, block, THREADS)
        if nbytes is not None:
            observability.count("write: windows native", len(stack))
            observability.count("write: window bytes", nbytes)
            return
    json_wins = {idx: win.tolist() for idx, win in enumerate(windows)}
    with open(path, "w") as handle:
        json.dump(json_wins, handle, indent=4)
    observability.count("write: windows fallback", len(json_wins))
    observability.count("write: window bytes", getsize(path))


def download_file(url, file, length=16 * 1024):
    """Copy ``url`` into the file ``file`` (``chromosight_tpu/io/
    writers.py:36-39``), failing with an ``OSError`` after
    ``DOWNLOAD_TIMEOUT`` seconds without an answer."""
    from urllib.request import urlopen

    with urlopen(url, timeout=DOWNLOAD_TIMEOUT) as req, open(file, "wb") as fp:
        shutil.copyfileobj(req, fp, length)


def check_prefix_dir(prefix):
    """Raise if the parent directory of an output prefix does not exist."""
    out_dir = dirname(prefix)
    if out_dir and not isdir(out_dir):
        raise OSError(f"Directory {out_dir} does not exist.")


def progress(count, total, status=""):
    """Draw an ANSI progress bar on stderr (``chromosight_tpu.io.progress``)."""
    bar_len = 20
    filled_len = int(round(bar_len * count / float(total)))
    percents = round(100.0 * count / float(total), 1)
    bar = "=" * filled_len + "-" * (bar_len - filled_len)
    sys.stderr.write("\r [%s] %s%s %s\033[K" % (bar, percents, "%", status))
    sys.stderr.flush()
