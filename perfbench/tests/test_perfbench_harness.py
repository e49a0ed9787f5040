"""The harness finds its configurations, cells, traffic and metric readers
by the names ``BENCHMARK.json`` gives, and they agree with it."""

import json

import pytest

from perfbench import harness
from perfbench.genome import load_config


@pytest.fixture(scope="module")
def spec():
    return harness.benchmark_spec()


def test_every_cell_file_matches_its_workload(spec):
    for wl in spec["workloads"]:
        cell = harness.load_cell(wl["name"])
        assert cell["config"] == wl["config"]
        assert cell["traffic"] == wl["traffic"]
        assert cell["chips"] == wl["chips"]
        assert cell["command_metric"] in harness.metrics_of(spec, wl["name"], "end_to_end")
        assert set(cell["limits"]) == {"unmatched_rows", "score_gap", "pvalue_gap",
                                       "qvalue_gap", "window_gap"}


def test_every_configuration_file_is_found(spec):
    used = {wl["config"] for wl in spec["workloads"]}
    for entry in spec["configs"]:
        cfg = load_config(entry["name"])
        assert cfg["name"] == entry["name"]
        assert entry["file"] == f"perfbench/configs/{entry['name']}.json"
        assert entry["source"] == cfg["source"]
        assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert used == {entry["name"] for entry in spec["configs"]}


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_cells_exist(spec, kind):
    cells = {wl["name"] for wl in spec["workloads"]}
    for metric in spec[kind]:
        assert set(metric.get("workloads", cells)) <= cells


def test_every_per_layer_metric_has_its_reader(spec):
    for metric in spec["per_layer"]:
        reader = harness.load_metric(metric["name"])
        assert reader.UNIT == metric["unit"]
        assert reader.LAYER == metric["layer"]
        assert reader.MOVES == metric["moves"]
        assert callable(reader.read)
        for cell in metric["workloads"]:
            assert metric["moves"] in harness.metrics_of(spec, cell, "end_to_end")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(spec):
    for wl in spec["workloads"]:
        e2e = harness.metrics_of(spec, wl["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(spec, wl["name"], "per_layer")


def test_unknown_names_raise():
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        load_config("no-such-config")
    with pytest.raises(FileNotFoundError):
        harness.load_metric("no_such_metric")


def test_traffic_names_its_pattern():
    for path in (harness.HERE / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        assert (harness.HERE / "patterns" / f"{traffic['pattern']}.json").is_file()
        assert traffic["argv"][0] == "detect"
        assert ("--inter" in traffic["argv"]) == traffic["inter"]


def test_metrics_of_selects_by_workloads():
    spec = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}]}
    assert harness.metrics_of(spec, "x", "end_to_end") == ["a", "b"]
    assert harness.metrics_of(spec, "y", "end_to_end") == ["a"]


def test_compare_counts_rows_in_one_table_only():
    import numpy as np

    from perfbench import check

    def table(b1, kid, score):
        n = len(b1)
        return {"chrom1": np.array(["chr1"] * n), "start1": np.array(b1) * 5000,
                "chrom2": np.array(["chr1"] * n), "start2": np.array(b1) * 5000 + 50000,
                "bin1": np.array(b1), "bin2": np.array(b1) + 10, "kernel_id": np.array(kid),
                "score": np.array(score, float), "pvalue": np.zeros(n), "qvalue": np.zeros(n)}

    ref = table([1, 2, 3], [0, 0, 1], [0.5, 0.6, 0.7])
    wins = np.zeros((3, 2, 2))
    port = table([1, 2, 3], [0, 1, 1], [0.5, 0.6, 0.7 + 1e-3])
    out = check.compare(port, wins, ref, wins)
    assert out["unmatched_rows"] == 2  # the same pixel by another kernel is another call
    assert abs(out["score_gap"] - 1e-3) < 1e-12
    nothing = check.compare(None, None, ref, wins)
    assert nothing["unmatched_rows"] == 3 and nothing["score_gap"] == 0.0
    nan_win = wins.copy()
    nan_win[0, 0, 0] = np.nan
    assert check.compare(ref, nan_win, ref, wins)["window_gap"] == check.NAN_GAP
