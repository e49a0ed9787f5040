"""The idle-share, breakdown and roofline arithmetic on a hand-made trace."""

import pytest

from perfbench import harness, trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("stage: io: fetch+scatter", "user_annotation", 0, 400),
    ev("stage: correlate", "user_annotation", 400, 200),
    ev("stage: host: write", "user_annotation", 600, 400),
    ev("band_pearson_tiled<17>", "kernel", 420, 100),
    ev("band_pearson_tiled<17>", "kernel", 450, 100),  # overlaps the first
    ev("Memcpy HtoD", "gpu_memcpy", 380, 30),
    ev("other", "kernel", 900, 50),
    ev("aten::add", "cpu_op", 0, 1000),
]


def test_busy_is_the_union_of_device_intervals():
    out = trace.summarize(EVENTS, window_s=0.001)
    # [380, 410] + [420, 550] + [900, 950] = 30 + 130 + 50 us
    assert out["busy_s"] == pytest.approx(210e-6)
    assert out["window_s"] == 0.001
    assert out["kernel_s"]["band_pearson_tiled<17>"] == pytest.approx(200e-6)


def test_busy_longer_than_the_window_fails_loudly():
    with pytest.raises(ValueError, match="busy"):
        trace.summarize(EVENTS, window_s=0.0002)


def test_idle_gaps_go_to_the_innermost_stage():
    out = trace.summarize(EVENTS, window_s=0.001)
    gaps = dict(out["breakdown"]["idle_gaps"])
    # gaps [0, 380] fetch, [410, 420] correlate, [550, 900] write, [950, 1000] write
    assert gaps["io: fetch+scatter"] == pytest.approx(380e-6)
    assert gaps["correlate"] == pytest.approx(10e-6)
    assert gaps["host: write"] == pytest.approx(400e-6)
    ops = out["breakdown"]["device_ops"]
    assert ops[0][0] == "band_pearson_tiled<17>"
    assert len(ops) == 3


def test_idle_share_reader():
    reader = harness.load_metric("idle_share.genome")
    run = harness.Run("c", 1, 0.001, {}, trace.summarize(EVENTS, 0.001))
    assert reader.read(run) == pytest.approx(100 * (1 - 0.21))
    assert reader.read(harness.Run("c", 1, 1.0, {})) is None


def test_roofline_reader():
    reader = harness.load_metric("band_pearson_roofline.genome")
    peaks = {"fma_per_s": 1e12, "bytes_per_s": 1e11}
    # two launches a command: one bound by its FMAs (1e6 FMA = 1 us), one
    # by its bytes (2e5 B = 2 us); two commands in the window ran the
    # kernel for 200 us in all
    work = {"band_launches": [(1e6, 1e4), (1e3, 2e5)]}
    run = harness.Run("c", 2, 0.001, {}, trace.summarize(EVENTS, 0.001), work, peaks)
    assert reader.read(run) == pytest.approx(100 * 2 * 3e-6 / 200e-6)
    # nothing to read: no kernel in the trace, no work, no peaks
    assert reader.read(harness.Run("c", 2, 0.001, {}, trace.summarize(EVENTS[:3], 0.001),
                                   work, peaks)) is None
    assert reader.read(harness.Run("c", 2, 0.001, {}, trace.summarize(EVENTS, 0.001),
                                   {}, peaks)) is None
    assert reader.read(harness.Run("c", 2, 0.001, {}, trace.summarize(EVENTS, 0.001),
                                   work, None)) is None


def test_stage_readers_divide_by_commands():
    run = harness.Run("c", 4, 10.0, {"io: fetch+scatter": 2.0, "host: write": 1.0,
                                     "tile scan": 8.0})
    assert harness.load_metric("io_fetch_s.genome").read(run) == 0.5
    assert harness.load_metric("host_write_s.genome").read(run) == 0.25
    assert harness.load_metric("tile_scan_s.inter").read(run) == 2.0
    assert harness.load_metric("tile_scan_s.inter").read(harness.Run("c", 4, 1.0, {})) is None
