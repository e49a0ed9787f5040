"""The readers of the port's inner spans on hand-made runs and traces:
the stage readers divide by the window's commands, the genome build sums
its three stages, the command's self time comes from the port's own
account, the scan's idle time from the trace's idle labels; each reads
None where its span did not run."""

import pytest

from perfbench import harness, trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_inner_stage_readers_divide_by_commands():
    run = harness.Run("c", 4, 10.0, {"io: decode": 2.0, "io: scatter": 1.0,
                                     "write: windows": 6.0, "io: fetch+scatter": 3.2})
    assert harness.load_metric("io_decode_s.genome").read(run) == 0.5
    assert harness.load_metric("io_scatter_s.genome").read(run) == 0.25
    assert harness.load_metric("write_windows_s.genome").read(run) == 1.5
    parent = harness.Run("c", 4, 10.0, {"io: fetch+scatter": 3.2, "host: write": 6.1})
    for name in ("io_decode_s.genome", "io_scatter_s.genome", "write_windows_s.genome"):
        assert harness.load_metric(name).read(parent) is None
        assert harness.load_metric(name).read(harness.Run("c", 0, 1.0, {"io: decode": 1.0,
                                                                         "io: scatter": 1.0,
                                                                         "write: windows": 1.0})) is None


def test_genome_build_sums_what_ran():
    reader = harness.load_metric("genome_build_s.genome")
    run = harness.Run("c", 2, 10.0, {"genome: open": 0.5, "genome: normalize": 0.1,
                                     "genome: maps": 0.2, "io: read": 9.0})
    assert reader.read(run) == pytest.approx(0.4)
    assert reader.read(harness.Run("c", 2, 10.0, {"genome: open": 0.5})) == 0.25
    assert reader.read(harness.Run("c", 2, 10.0, {"io: fetch+scatter": 1.0})) is None


def test_command_self_time_reader(monkeypatch):
    from chromosight_torch import observability

    reader = harness.load_metric("command_self_s.genome")
    run = harness.Run("c", 4, 10.0, {})
    monkeypatch.setattr(observability, "self_seconds", lambda: {"command": 0.2, "io: read": 3},
                        raising=False)
    assert reader.read(run) == pytest.approx(0.05)
    assert reader.read(harness.Run("c", 0, 10.0, {})) is None
    monkeypatch.setattr(observability, "self_seconds", lambda: {"io: read": 3}, raising=False)
    assert reader.read(run) is None
    # a program that keeps no self time (the parent of the spans)
    monkeypatch.delattr(observability, "self_seconds", raising=False)
    assert reader.read(run) is None


def test_tile_scan_idle_reader():
    reader = harness.load_metric("tile_scan_idle_s.inter")
    events = [
        ev("stage: command", "user_annotation", 0, 1000),
        ev("stage: tile scan", "user_annotation", 100, 800),
        ev("stage: tile: scatter", "user_annotation", 150, 100),
        ev("stage: tile: kept", "user_annotation", 500, 200),
        ev("stage: io: trans fetch", "user_annotation", 0, 100),
        ev("k", "kernel", 250, 250),
        ev("k", "kernel", 700, 250),
    ]
    summary = trace.summarize(events, window_s=0.001)
    gaps = dict(summary["breakdown"]["idle_gaps"])
    # [0, 250] midpoint 125: tile scan; [500, 700] tile: kept; [950, 1000] command
    assert gaps == pytest.approx({"tile scan": 250e-6, "tile: kept": 200e-6,
                                  "command": 50e-6})
    run = harness.Run("c", 2, 0.001, {}, summary)
    assert reader.read(run) == pytest.approx(450e-6 / 2)
    assert reader.read(harness.Run("c", 2, 0.001, {})) is None
    untiled = trace.summarize(events[:1] + events[4:], window_s=0.001)
    assert reader.read(harness.Run("c", 2, 0.001, {}, untiled)) is None
