"""Runs of every cell through ``perfbench/run.py`` on a CUDA card: short
windows, each run correct and its result line of the contract's shape.
Skipped without a card (the port's kernels have no CPU build).

    python3 -m pytest perfbench/tests/test_perfbench_card.py -m card
"""

import json
import pathlib
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's band kernel is built and run only on one")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark_spec()["workloads"]])
def test_cell_runs_correct_on_the_card(cell, trace, tmp_path):
    need_card()
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed", "3141592653",
         "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
        env={**__import__("os").environ, "TMPDIR": str(tmp_path)},
    )
    assert res.returncode == 0, res.stderr[-4000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    assert set(result["metrics"]) == set(harness.metrics_of(harness.benchmark_spec(), cell, kind))


def test_run_refuses_without_enough_cards(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "hg38-5kb-loops", "--seed", "1", "--seconds", "1"], 0.0)
    assert rc != 0
    assert capsys.readouterr().out == ""
