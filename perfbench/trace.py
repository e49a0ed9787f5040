"""The traced window: ``torch.profiler`` over the whole window, then the
device's busy time, its operations by time and its idle gaps by what the
host was doing, all from the Chrome trace the profiler exports.

* busy: the union of the trace's kernel, memcpy and memset intervals;
* device operations: the seconds of each kernel, memcpy or memset name;
* idle gaps: the stretches of the traced span with no device interval,
  each put down to the innermost ``stage: <name>`` range of the host
  that covers its middle (``harness.stage_annotations`` makes the port's
  stages such ranges), summed by that name.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGE_PREFIX = "stage: "
TOP = 10


def start(device):
    """A running profiler of the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


def stop(prof, window_s):
    """Stop ``prof`` and summarise its trace (``summarize``)."""
    prof.__exit__(None, None, None)
    path = pathlib.Path(tempfile.gettempdir()) / "perfbench-trace.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, window_s)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events, window_s):
    """{"busy_s", "window_s", "kernel_s", "breakdown"} of a Chrome trace's
    events (microsecond timestamps); ``window_s`` is the window's length
    by the host's clock."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e and "ts" in e]
    device = [e for e in complete if e.get("cat") in DEVICE_CATS]
    stages = [e for e in complete if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith(STAGE_PREFIX)]
    by_name = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device])
    busy_us = sum(e - s for s, e in busy)
    if complete:
        t_lo = min(float(e["ts"]) for e in complete)
        t_hi = max(float(e["ts"]) + float(e["dur"]) for e in complete)
    else:
        t_lo = t_hi = 0.0
    edges = [t_lo] + [x for iv in busy for x in iv] + [t_hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges) - 1, 2)
            if edges[k + 1] > edges[k]]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(STAGE_PREFIX):])
                    for e in stages), key=lambda s: s[1] - s[0])
    starts = np.array([s[0] for s in spans])
    ends = np.array([s[1] for s in spans])
    idle = {}
    for s, e in gaps:
        mid = (s + e) / 2
        hit = np.flatnonzero((starts <= mid) & (ends >= mid)) if len(spans) else []
        label = spans[hit[0]][2] if len(hit) else "outside the port's stages"
        idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    if busy_us / 1e6 > window_s:
        raise ValueError(f"the device was busy {busy_us / 1e6} s in a window of {window_s} s: "
                         "the union of its intervals is wrong")
    return {
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "kernel_s": by_name,
        "breakdown": {
            "device_ops": [[name, secs] for name, secs in ops],
            "idle_gaps": [[name, secs] for name, secs in gaps_top],
        },
    }
