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
