"""Shared set-up of the benchmark's own tests: the checkout on the import
path, the ``card`` marker, and the cells cut to a few thousand bins for
the CPU."""

import pathlib
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# three chromosomes of a few thousand bins: every layer of a cell, at a
# size the CPU runs in seconds
SMALL_CHROMS = [["chr1", 15_000_000], ["chr2", 12_000_000], ["chr3", 9_000_000]]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def small_cell(name, chroms=SMALL_CHROMS):
    """The cell ``name`` with its genome cut to ``chroms``."""
    from perfbench import harness

    cell = harness.load_cell(name)
    cell["config_data"]["chroms"] = [list(c) for c in chroms]
    return cell


def run_small(cell, tmp_path, seed=5, trace=0, seconds=0.0):
    """One run of ``cell`` on the CPU (the harness without its look for a
    card): (exit code, the result line as a dict)."""
    import json
    import time

    import torch

    from perfbench import harness

    spec = harness.benchmark_spec()
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    out = tmp_path / "stdout.txt"
    old = sys.stdout
    with open(out, "w") as handle:
        sys.stdout = handle
        try:
            rc = harness.run_cell(cell, spec, args, time.perf_counter(), torch.device("cpu"),
                                  [torch.device("cpu")], cache=tmp_path / "cache")
        finally:
            sys.stdout = old
    lines = out.read_text().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture
def tmpdir_env(tmp_path, monkeypatch):
    """The run's temporary directory under the test's own."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path

