"""Stage snapshots of ``detect --dump DIR``, and ``DumpMatrix``.

Counterpart of ``chromosight_tpu/runtime/dump.py`` and of the snapshots of
``chromosight_tpu/detection.py:1058-1150, 1504-1519, 1895-1908``: each
stage of a map is saved as ``DIR/<map name>_<stage>.npz``, a scipy-sparse
CSR matrix in matrix coordinates (float64 for the band engine's maps).
scipy is imported only when a snapshot is written.

Each snapshot says so on stdout through ``announce``; the scheduler
collects a map's lines with ``collect`` while its thread works on it, and
prints them in map order.
"""

from __future__ import annotations

import pathlib
import threading
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from chromosight_torch.device import download

_SINK = threading.local()


def announce(line):
    """Print ``line``, or keep it in the list the calling thread collects
    into (``collect``)."""
    lines = getattr(_SINK, "lines", None)
    if lines is None:
        print(line)
    else:
        lines.append(line)


@contextmanager
def collect(lines):
    """Keep what ``announce`` says in this thread in ``lines``."""
    before = getattr(_SINK, "lines", None)
    _SINK.lines = lines
    try:
        yield lines
    finally:
        _SINK.lines = before


def save_snapshot(dump_dir, name, stage, rows, cols, vals, n):
    """Save the (n, n) matrix of the triplets (rows, cols, vals) as
    ``dump_dir/<name>_<stage>.npz``."""
    import scipy.sparse as sp

    mat = sp.coo_matrix(
        (np.asarray(vals, dtype=np.float64), (rows, cols)), shape=(n, n)
    ).tocsr()
    sp.save_npz(pathlib.Path(dump_dir) / f"{name}_{stage}", mat)


def save_band_snapshot(dump_dir, name, stage, band, n, after):
    """Snapshot of a (rows, W) band ``B[i, d] = M[i, i + d]``: its
    nonzero pixels (NaN included) with i < n and i + d < n, as the upper
    triangle of the (n, n) matrix.  Says so on stdout, as the JAX
    package's ``DumpMatrix`` does after the method ``after``."""
    band = download(band[:n]).astype(np.float64)
    i, d = np.nonzero(band)
    ok = i + d < n
    i, d = i[ok], d[ok]
    path = pathlib.Path(dump_dir) / f"{name}_{stage}"
    announce(f"Dumping matrix to {path} after executing {after}")
    save_snapshot(dump_dir, name, stage, i, i + d, band[i, d], n)


def save_matrix_snapshot(dump_dir, name, stage, mat, after=None):
    """Snapshot of a whole map (a dense numpy array or a scipy sparse
    matrix) as a CSR matrix of its dtype; says so on stdout after the
    method ``after``, when given."""
    import scipy.sparse as sp

    path = pathlib.Path(dump_dir) / f"{name}_{stage}"
    if after is not None:
        announce(f"Dumping matrix to {path} after executing {after}")
    sp.save_npz(path, mat.tocsr() if sp.issparse(mat) else sp.csr_matrix(np.asarray(mat)))


class DumpMatrix:
    """Method decorator that snapshots ``inst.matrix`` after the call: the
    JAX package's ``DumpMatrix`` (``chromosight_tpu/runtime/dump.py:17-53``,
    the reference ``contacts_map.py:23-76``).

    The dump path is ``inst.dump / f"{inst.name}_{dump_name}"`` (or just
    ``dump_name`` when the instance has no name), a scipy-sparse npz of
    the matrix (a CSR copy of a dense one).  Instances with ``dump=None``
    skip dumping entirely.  The line that says so goes through
    ``announce``."""

    def __init__(self, dump_name):
        self.dump_name = dump_name

    def __call__(self, fn, *args, **kwargs):
        def decorated_fn(*args, **kwargs):
            res = fn(*args, **kwargs)
            inst = args[0]
            if (
                hasattr(inst, "matrix")
                and getattr(inst, "dump", None) is not None
                and self.dump_name is not None
            ):
                import scipy.sparse as sp

                if getattr(inst, "name", None):
                    dump_path = Path(inst.dump) / f"{inst.name}_{self.dump_name}"
                else:
                    dump_path = Path(inst.dump) / f"{self.dump_name}"
                announce(f"Dumping matrix to {dump_path} after executing {fn.__name__}")
                mat = inst.matrix
                if not sp.issparse(mat):
                    mat = sp.csr_matrix(np.asarray(mat))
                sp.save_npz(dump_path, mat)
            return res

        return decorated_fn
