"""The port's instruments (chromosight_torch.observability), on the CPU.

Each test of tests/test_observability.py on the port's cost accounting
(a cost function per program family instead of XLA's cost analysis),
then: the link bytes of a CPU ``detect`` against the shapes of what it
uploads and downloads, the program families and their dispatch counts
against the JAX package's for the same run, the exit report (in process
and from a subprocess of the command line), ``device_peaks`` and
``maybe_trace``.
"""

import io
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chromosight_torch.observability as obs
from chromosight_torch.ops.band import pearson_flops
from chromosight_torch.ops.band_pearson import band_cost
from torch_parity import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
EXAMPLE_NPZ = ROOT / "tests" / "data" / "example_cool.npz"


def setup_function(_fn):
    obs.reset()


def _mm_cost(a, b):
    flops, unfused = obs.plain_cost(torch.mm, a, b)
    io_min = 4 * (a.numel() + b.numel() + a.shape[0] * b.shape[1])
    return flops, io_min, unfused


def test_account_dispatch_matmul_flops_and_io_bounds():
    m, k, n = 64, 128, 32
    a = torch.zeros((m, k))
    b = torch.zeros((k, n))
    obs.account_dispatch("mm", _mm_cost, a, b)
    obs.account_dispatch("mm", _mm_cost, a, b)
    snap = obs.compute_snapshot()
    assert set(snap) == {"mm"}
    rec = snap["mm"]
    assert rec["dispatches"] == 2
    # logical matmul flops = 2*m*k*n per dispatch
    assert rec["flops"] == 2 * (2 * m * k * n)
    io_min = 4 * (m * k + k * n + m * n)
    assert rec["hbm_min_bytes"] == 2 * io_min
    assert rec["hbm_unfused_bytes"] >= rec["hbm_min_bytes"]


def test_cost_cache_ignores_traced_scalar_values():
    """Bare positional scalars (row counts, max_dist) must not fragment
    the cost cache: one cost per shape, not one per chromosome; keyword
    scalars do key it."""
    calls = []

    def cost(a, n, scale=1):
        calls.append(n)
        return a.numel(), 4 * a.numel(), 8 * a.numel()

    a = torch.zeros((8, 8))
    obs.account_dispatch("scaled", cost, a, 3)
    before = len(obs._COST_CACHE)
    obs.account_dispatch("scaled", cost, a, 7)  # same shapes, new scalar
    assert len(obs._COST_CACHE) == before and calls == []  # evaluated when asked
    assert obs.compute_snapshot()["scaled"]["dispatches"] == 2
    assert calls == [3]
    obs.account_dispatch("scaled", cost, torch.zeros((4, 8)), 7)
    obs.account_dispatch("scaled", cost, a, 7, scale=2)
    assert len(obs._COST_CACHE) == before + 2
    assert obs.compute_snapshot()["scaled"]["flops"] == 3 * 64 + 32
    assert len(calls) == 3
    obs.compute_snapshot()
    assert len(calls) == 3


def test_account_dispatch_never_raises_on_bad_args():
    obs.account_dispatch("broken", lambda a: a.shape, object())
    assert obs.compute_snapshot()["broken"]["flops"] == 0.0
    assert obs.compute_snapshot()["broken"]["dispatches"] == 1


def test_reset_clears_compute_totals():
    obs.account_dispatch("x", _mm_cost, torch.zeros((2, 2)), torch.zeros((2, 2)))
    obs.add_bytes("upload", 16)
    obs.record_band_upload("chr1-chr1", "u4", 3, (10, 4))
    with obs.stage("s"):
        pass
    obs.reset()
    assert obs.compute_snapshot() == {}
    assert obs.snapshot() == ({}, {}, {})
    assert obs.band_uploads() == {}


def test_band_uploads_keep_each_maps_last_upload():
    """``band_uploads`` holds the last form each map's band took, as a
    copy the caller cannot alter."""
    obs.reset()
    obs.record_band_upload("chr1-chr1", "f32", 0, (10, 4))
    obs.record_band_upload("chr2-chr2", "u8", 2, (7, 4))
    obs.record_band_upload("chr1-chr1", "u4", 5, (10, 4))
    got = obs.band_uploads()
    assert got == {"chr1-chr1": {"mode": "u4", "exceptions": 5, "shape": (10, 4)},
                   "chr2-chr2": {"mode": "u8", "exceptions": 2, "shape": (7, 4)}}
    got["chr1-chr1"]["mode"] = "u16"
    assert obs.band_uploads()["chr1-chr1"]["mode"] == "u4"
    obs.reset()


def test_device_peaks_cpu_is_none(monkeypatch):
    """None peaks on the CPU; on a card the table's public numbers, the
    environment's overrides, and no guess for a card missing from it."""
    assert obs.device_peaks("cpu") == (None, None, "cpu")
    if not torch.cuda.is_available():
        assert obs.device_peaks() == (None, None, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda _=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.delenv("CHROMOSIGHT_TPU_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("CHROMOSIGHT_TPU_PEAK_HBM_GBPS", raising=False)
    assert obs.device_peaks() == (66.9e12, 3.35e12, "NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("CHROMOSIGHT_TPU_PEAK_TFLOPS", "33.5")
    monkeypatch.setenv("CHROMOSIGHT_TPU_PEAK_HBM_GBPS", "2000")
    assert obs.device_peaks() == (33.5e12, 2000e9, "NVIDIA H100 80GB HBM3")
    monkeypatch.delenv("CHROMOSIGHT_TPU_PEAK_TFLOPS")
    monkeypatch.delenv("CHROMOSIGHT_TPU_PEAK_HBM_GBPS")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda _=None: "Some Card")
    assert obs.device_peaks() == (None, None, "Some Card")


def test_band_cost_scales_with_kernel_taps():
    """The band family's FLOPs track the kernel's taps (the shape count
    of ``pearson_flops``), whatever the band holds."""
    n_pad, width = 256, 64

    def run(km, kn, name, fill=0.0):
        sig = torch.full((n_pad + 2 * (km - 1), width + km - 1 + kn - 1), fill)
        obs.account_dispatch(name, band_cost, sig, sig.clone(), np.ones((1, km, kn)))
        return obs.compute_snapshot()[name]

    small = run(3, 3, "band3")
    big = run(7, 7, "band7")
    assert big["flops"] > 2 * small["flops"]
    assert small["flops"] == pearson_flops(n_pad * width, 1, 3, 3)
    assert run(7, 7, "band7_ones", 1.0)["flops"] == big["flops"]
    assert big["hbm_unfused_bytes"] > big["hbm_min_bytes"] > 0


def test_report_into_stringio():
    with obs.stage("correlate"):
        pass
    obs.account_dispatch("mm", _mm_cost, torch.zeros((4, 4)), torch.zeros((4, 4)))
    out = io.StringIO()
    obs.report(out)
    text = out.getvalue()
    assert "-- chromosight-torch stage timings --" in text
    assert "correlate" in text and "(1 calls)" in text
    assert "-- compute accounting (per program family) --" in text
    assert "mm" in text and "TFLOP" in text and "(1 dispatches)" in text
    obs.reset()
    out = io.StringIO()
    obs.report(out)
    assert out.getvalue() == ""


def _port_detect(prefix, pattern):
    from chromosight_torch.cli.main import main

    obs.reset()
    argv = ["detect", "--no-plotting", "--pattern", pattern, str(EXAMPLE_NPZ), prefix]
    assert main(argv, device="cpu") == 0
    return obs.compute_snapshot(), obs.snapshot()[2]


def _expected_link_bytes(pattern):
    """Uploads and downloads of a CPU detect of the example, worked out
    from shapes: each chromosome's band as the count path ships it (its
    packed raw counts, 8 bytes per exception and the rows' float64
    weights);
    per chromosome and kernel, the candidates' (row, diagonal, corr)
    (int64, int64, float32) and each focus' score, log10 p and window
    (float32).  The candidates and foci come from the plain twin and the
    full-matrix ``pick_foci``."""
    from chromosight_torch.detection import frame_contact_map, pick_foci
    from chromosight_torch.io.config import load_kernel_config
    from chromosight_torch.ops.band import pearson_reference_multi
    from chromosight_torch.runtime import contact_map
    from chromosight_torch.runtime.genome import HicGenome

    cfg = load_kernel_config(pattern)
    kernels = np.stack(cfg["kernels"])
    genome = HicGenome(str(EXAMPLE_NPZ), kernel_config=cfg, device="cpu")
    genome.normalize("auto")
    genome.make_sub_matrices()
    up = down = 0
    for cm in genome.sub_mats.contact_map:
        cm.create_mat()
        n = cm.shape[0]
        (s, e), _ = cm.extent
        pack = cm.clr.band_upper_counts_auto((s, e), cm.keep_distance + 1,
                                             u4_head=contact_map.U4_HEAD)
        mode, *arrays = pack
        if mode != "u16":  # exceptions ship as int32 indices and float32 values
            arrays = arrays[:-2] + [np.zeros(2 * len(arrays[-1]), np.float32)]
        up += sum(a.nbytes for a in arrays) + 8 * n
        sig_p, mask_p = frame_contact_map(cm, kernels.shape[1:])
        corr, _, cand = pearson_reference_multi(
            sig_p, mask_p, kernels, n, cm.max_dist, cfg["max_perc_undetected"] / 100,
            cfg["pearson"],
        )
        for k in range(len(kernels)):
            down += 20 * int(cand[k].sum())
            i, d = np.nonzero(cand[k].numpy())
            ok = i + d < n
            dense = np.zeros((n, n))
            dense[i[ok], i[ok] + d[ok]] = corr[k].numpy()[i[ok], d[ok]]
            foci = pick_foci(dense, cfg["pearson"])[0]
            n_foci = 0 if foci is None else len(foci)
            down += 4 * n_foci * (2 + kernels.shape[1] * kernels.shape[2])
        cm.destroy_mat()
    return up, down


@pytest.mark.parametrize("pattern", ["loops", "borders"])
def test_detect_link_bytes_match_the_shapes(tmp_path, pattern):
    """``add_bytes`` totals of a CPU detect on the example's npz export:
    the band uploads and the candidate and tail downloads."""
    _, link = _port_detect(str(tmp_path / pattern), pattern)
    up, down = _expected_link_bytes(pattern)
    assert link == {"upload": up, "download": down}


@pytest.mark.parametrize("pattern", ["loops", "borders"])
def test_families_match_the_jax_package(tmp_path, pattern, monkeypatch):
    """The program families and their dispatch counts of a CPU detect of
    the example equal what the JAX package records for its own run of the
    same map: band_preprocess and band_normxcorr (loops) or
    band_normxcorr_multi (borders' fused three kernels), once per
    chromosome.  The JAX run is held to one device: on the test harness's
    eight-device CPU mesh it shards the maps through a mesh program that
    it accounts under no family (the port has no mesh)."""
    import chromosight_tpu.observability as jax_obs
    from chromosight_tpu.cli.main import main as jax_main

    monkeypatch.setenv("CHROMOSIGHT_TPU_MESH", "0")
    ours, _ = _port_detect(str(tmp_path / "port"), pattern)
    jax_obs.reset()
    argv = ["detect", "--no-plotting", "--pattern", pattern,
            str(ROOT / "data_test" / "example.cool"), str(tmp_path / "jax")]
    assert jax_main(argv) == 0
    theirs = jax_obs.compute_snapshot()
    jax_obs.reset()
    family = "band_normxcorr" if pattern == "loops" else "band_normxcorr_multi"
    assert {k: v["dispatches"] for k, v in ours.items()} == {
        k: v["dispatches"] for k, v in theirs.items()
    } == {"band_preprocess": 3, family: 3}
    assert all(v["flops"] > 0 and v["hbm_min_bytes"] > 0 for v in ours.values())


def test_cli_prints_the_report_at_exit(tmp_path):
    """The command line on the CPU with CHROMOSIGHT_TPU_TIMINGS=1 prints
    the stage and compute report when the process exits."""
    code = (
        "from chromosight_torch.cli.main import main; "
        f"main(['detect', '--no-plotting', {str(EXAMPLE_NPZ)!r}, "
        f"{str(tmp_path / 'out')!r}], device='cpu')"
    )
    env = dict(os.environ, CHROMOSIGHT_TPU_TIMINGS="1")
    env.pop("CHROMOSIGHT_TPU_PROFILE", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    report = res.stderr[res.stderr.index("-- chromosight-torch stage timings --"):]
    assert "correlate" in report and "-- compute accounting (per program family) --" in report
    assert "band_normxcorr " in report and "(3 dispatches)" in report
    assert "band_preprocess" in report


def test_maybe_trace_starts_no_profiler_unless_asked(tmp_path, monkeypatch):
    """Without CHROMOSIGHT_TPU_PROFILE the block runs with no profiler;
    with it set to a directory, a trace file lands there."""
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler was started")

    monkeypatch.delenv("CHROMOSIGHT_TPU_PROFILE", raising=False)
    with monkeypatch.context() as patch:
        patch.setattr(torch.profiler, "profile", refuse)
        with obs.maybe_trace():
            torch.ones(4).sum()
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("CHROMOSIGHT_TPU_PROFILE", str(trace_dir))
    with obs.maybe_trace():
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1 and "aten::mm" in traces[0].read_text()


# -- spans, self time and counters ------------------------------------- #
def _spin(seconds):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def test_self_time_of_nested_spans():
    """A span's self time is its duration less its children's on the same
    thread; the totals and counts keep their meaning."""
    with obs.stage("outer"):
        _spin(0.01)
        with obs.stage("inner"):
            _spin(0.02)
            with obs.stage("leaf"):
                _spin(0.01)
        with obs.stage("inner"):
            pass
    totals, counts, _ = obs.snapshot()
    own = obs.self_seconds()
    assert counts == {"outer": 1, "inner": 2, "leaf": 1}
    assert own["leaf"] == pytest.approx(totals["leaf"])
    assert own["inner"] == pytest.approx(totals["inner"] - totals["leaf"])
    assert own["outer"] == pytest.approx(totals["outer"] - totals["inner"])
    assert own["outer"] >= 0.01 and own["inner"] >= 0.02


def test_spans_of_another_thread_are_not_children():
    """A span opened on another thread while one is open here subtracts
    nothing from it: each thread has its own stack."""
    import threading

    def work():
        with obs.stage("worker"):
            _spin(0.03)

    with obs.stage("main"):
        thread = threading.Thread(target=work)
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
    totals, _, _ = obs.snapshot()
    own = obs.self_seconds()
    assert totals["worker"] >= 0.03
    assert own["main"] == pytest.approx(totals["main"])
    assert own["worker"] == pytest.approx(totals["worker"])


def test_counters_from_several_threads_and_reset():
    """``count`` adds under the lock from many threads at once (more
    threads than cores, the switch interval shortened); ``reset`` clears
    the counters and the self times."""
    import threading

    n_threads, n_adds = 4 * (os.cpu_count() or 1), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(n_adds):
                obs.count("test: adds")
                obs.count("test: pairs", 2)

        threads = [threading.Thread(target=add) for _ in range(n_threads)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
        assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    assert obs.counters() == {"test: adds": n_threads * n_adds,
                              "test: pairs": 2 * n_threads * n_adds}
    got = obs.counters()
    got["test: adds"] = 0
    assert obs.counters()["test: adds"] == n_threads * n_adds
    with obs.stage("s"):
        pass
    obs.reset()
    assert obs.counters() == {} and obs.self_seconds() == {}


def test_report_prints_self_time_and_counters():
    with obs.stage("outer"):
        with obs.stage("inner"):
            pass
    obs.count("io: pixels scattered", 1234567)
    out = io.StringIO()
    obs.report(out)
    text = out.getvalue()
    assert "outer" in text and " self " in text
    assert "-- counters --" in text and "1,234,567" in text


def test_no_profiler_range_without_a_profiler(monkeypatch, tmp_path):
    """Without a profiler recording, neither a stage nor a map's work
    enters a ``record_function`` range, through a whole CPU detect."""
    import torch.autograd.profiler
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with obs.stage("s"), obs.on_map("chr1-chr1"):
        pass
    from chromosight_torch.cli.main import main

    argv = ["detect", "--no-plotting", str(EXAMPLE_NPZ), str(tmp_path / "out")]
    assert main(argv, device="cpu") == 0
    assert obs.snapshot()[1]["command"] == 1


def _ranges(trace_file):
    """[(name, start, end, tid)] of the ``stage:`` and ``map:`` ranges of
    a Chrome trace, in microseconds."""
    import json

    events = json.loads(pathlib.Path(trace_file).read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and str(e["name"]).startswith(("stage: ", "map: "))]


def _inside(inner, outer):
    return outer[3] == inner[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("source", ["example.cool", "example_cooler_layout.cool"])
def test_detect_trace_holds_the_spans(tmp_path, source):
    """A CPU detect under ``torch.profiler`` exports ranges ``stage:
    <name>`` on the profiler's clock: ``command`` encloses the genome's
    open, the reader's read (and, in cooler's compressed layout, its
    decode), its scatter and both writes; each map's stages lie in its
    ``map: <name>`` range; ``command``'s duration is its self time plus
    its direct children's."""
    from torch.profiler import ProfilerActivity, profile

    from chromosight_torch.cli.main import main

    path = ROOT / ("data_test" if source == "example.cool" else "tests/data") / source
    argv = ["detect", "--no-plotting", str(path), str(tmp_path / "out")]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert main(argv, device="cpu") == 0
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    ranges = _ranges(tmp_path / "trace.json")
    (command,) = [r for r in ranges if r[0] == "stage: command"]
    names = {r[0] for r in ranges if _inside(r, command)}
    wanted = {"genome: open", "genome: normalize", "genome: maps", "io: read", "io: scatter",
              "io: fetch+scatter", "host: write", "write: table", "write: windows"}
    if source != "example.cool":
        wanted |= {"io: decode", "io: index"}
    assert {f"stage: {n}" for n in wanted} <= names
    maps = [r for r in ranges if r[0].startswith("map: ")]
    assert sorted(r[0] for r in maps) == ["map: chr1-chr1", "map: chr2-chr2", "map: chr3-chr3"]
    fetches = [r for r in ranges if r[0] == "stage: io: fetch+scatter"]
    assert len(fetches) == 3
    for fetch in fetches:
        assert sum(_inside(fetch, m) for m in maps) == 1

    # the stages directly inside ``command``: each name sits at one depth
    stages = [r for r in ranges if r[0].startswith("stage: ")]

    def parent(r):
        outer = [o for o in stages if o is not r and _inside(r, o)]
        return min(outer, key=lambda o: o[2] - o[1]) if outer else None

    direct = {r[0][len("stage: "):] for r in stages if parent(r) is command}
    deeper = {r[0][len("stage: "):] for r in stages if r is not command
              and parent(r) is not command}
    assert not direct & deeper
    assert {"genome: open", "io: fetch+scatter", "host: write"} <= direct
    assert {"io: read", "io: scatter", "write: table"} <= deeper
    totals = obs.snapshot()[0]
    children = sum(totals[name] for name in direct)
    assert totals["command"] == pytest.approx(obs.self_seconds()["command"] + children, abs=1e-3)


def test_detect_runs_under_the_benchmarks_stage_wrapper(tmp_path):
    """The benchmark's traced runs wrap ``observability.stage`` in a range
    of the same name (``perfbench.harness.stage_annotations``); a CPU
    detect under that wrapper and a profiler completes, with the ranges
    doubled and the totals counted once."""
    from torch.profiler import ProfilerActivity, profile

    from chromosight_torch.cli.main import main
    from perfbench import harness

    timer = obs.stage
    try:
        harness.stage_annotations()
        argv = ["detect", "--no-plotting", str(EXAMPLE_NPZ), str(tmp_path / "out")]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert main(argv, device="cpu") == 0
    finally:
        obs.stage = timer
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    commands = [r for r in _ranges(tmp_path / "trace.json") if r[0] == "stage: command"]
    assert len(commands) == 2 and obs.snapshot()[1]["command"] == 1
    assert (tmp_path / "out.tsv").read_bytes().count(b"\n") == 90


def test_tile_counters(monkeypatch):
    """The tiled engine's counters at a scan: tiles scanned and skipped
    over the grid, one batch per ``TILE_BATCH`` scanned tiles, one Pearson
    call per ``PEARSON_TILES`` tiles of a batch, and the kept pixels
    (before the frame is cropped)."""
    import scipy.sparse as sp

    import chromosight_torch.ops.tiled as tiled

    monkeypatch.setattr(tiled, "TILE_BATCH", 3)
    rng = np.random.RandomState(3)
    signal = sp.random(300, 420, density=0.01, random_state=rng, format="csr")
    signal = signal.tolil()
    signal[:, 250:] = 0
    kernel = np.ones((5, 5)) + rng.rand(5, 5)
    corr, _ = tiled.normxcorr2_sparse_tiled(signal.tocsr(), kernel, full=True, tile=64,
                                            device="cpu")
    got = obs.counters()
    n_tiles = -(-(300 + 8) // 64) * -(-(420 + 8) // 64)
    scanned = got["tiles: scanned"]
    assert scanned + got["tiles: skipped"] == n_tiles and got["tiles: skipped"] > 0
    assert got["tiles: batches"] == -(-scanned // 3)
    batches = [min(3, scanned - k) for k in range(0, scanned, 3)]
    assert got["tiles: launches"] == sum(-(-b // tiled.PEARSON_TILES) for b in batches)
    assert got["tiles: kept pixels"] >= corr.nnz > 0


def test_reader_counters_of_a_compressed_file(tmp_path):
    """The reader's counters on cooler's compressed layout: every pixel of
    the three chromosomes' rows scattered once (the u4 count path), the
    chunks decoded and their bytes, and the compressed bytes read, fewer
    than those decoded (a chunk across two chromosomes is read by both
    maps)."""
    from chromosight_torch.cli.main import main
    from chromosight_torch.io.cool import CoolFile

    path = ROOT / "tests" / "data" / "example_cooler_layout.cool"
    argv = ["detect", "--no-plotting", str(path), str(tmp_path / "out")]
    assert main(argv, device="cpu") == 0
    got = obs.counters()
    clr = CoolFile(str(path))
    assert got["io: pixels scattered"] == clr.nnz
    assert got["io: chunks decoded"] > 0
    assert 0 < got["io: bytes read"] < got["io: bytes decoded"]


@pytest.mark.parametrize("decline", ["u4", "native decode"])
def test_reader_counts_once_where_a_fast_path_declines(tmp_path, monkeypatch, decline):
    """Where the u4 packing declines (its exceptions outgrow what it
    saves) the pixels are still counted once, by the form that takes them;
    where the threaded native decode declines, the chunk-by-chunk decode
    that follows counts its own reads and chunks, and the declined read is
    not counted beside them."""
    from chromosight_torch import native
    from chromosight_torch.cli.main import main
    from chromosight_torch.io.cool import CoolFile

    path = ROOT / "tests" / "data" / "example_cooler_layout.cool"

    def run(prefix):
        obs.reset()
        assert main(["detect", "--no-plotting", str(path), str(tmp_path / prefix)],
                    device="cpu") == 0
        return obs.counters()

    fast = run("fast")
    if decline == "u4":
        monkeypatch.setattr(native, "band_scatter_counts_u4_indptr", lambda *a, **k: None)
    else:
        monkeypatch.setattr(native, "inflate_chunks", lambda *a, **k: False)
        monkeypatch.setattr(native, "szip_chunks", lambda *a, **k: False)
    got = run("declined")
    assert got["io: pixels scattered"] == fast["io: pixels scattered"] == CoolFile(str(path)).nnz
    assert got["io: chunks decoded"] == fast["io: chunks decoded"] > 0
    assert got["io: bytes decoded"] == fast["io: bytes decoded"]
    # the native path reads whole runs of nearby chunks, gaps included
    assert 0 < got["io: bytes read"] <= fast["io: bytes read"]
