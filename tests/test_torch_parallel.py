"""The per-chromosome scheduler (``chromosight_torch.parallel``) on CPU:
``--threads`` and device lists give byte for byte the serial run's
tables and windows (detect, fused borders, retained maps over two
iterations, quantify, ``--inter`` with the tiles of a trans map spread
over two devices, ``--subsample`` with one seed), the pipelined and
multi-device paths are shown to run, no map is ever created twice at
once, and the scheduler keeps its order, its counters and its threads
under stress and failure."""

import contextlib
import io
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

import chromosight_torch.cli.main as tcli
import chromosight_torch.ops.tiled as ttiled
import chromosight_torch.runtime.contact_map as tcm
from chromosight_torch.device import resolve_devices
from chromosight_torch.parallel import MAPS_RUN, MapScheduler, retain_maps
from chromosight_torch.runtime.contact_map import ContactMap
from torch_parity import torch_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).parents[1]
EXAMPLE_NPZ = str(ROOT / "tests" / "data" / "example_cool.npz")
EXAMPLE_BED2 = str(ROOT / "data_test" / "example.bed2")

# name -> (argv before the map, threads and devices of the serial run,
# the runs held against it); a short scan distance keeps each run quick
CASES = {
    "loops": (["detect"], [("3", "cpu"), ("1", ["cpu", "cpu"]), ("2", ["cpu", "cpu"])]),
    "borders": (["detect", "--pattern", "borders"], [("3", "cpu"), ("1", ["cpu", "cpu"])]),
    "iterations": (["detect", "--iterations", "2"], [("3", "cpu"), ("1", ["cpu", "cpu"])]),
    "quantify": (["quantify", EXAMPLE_BED2], [("3", "cpu"), ("1", ["cpu", "cpu", "cpu"])]),
    "inter_tiled": (["detect", "--inter", "--max-dist", "60000"], [("1", ["cpu", "cpu"])]),
}


def run(tmp_path, tag, argv, threads, device, rng=None):
    """The port's CLI run; (tsv bytes, windows bytes, stdout)."""
    prefix = str(tmp_path / tag)
    out = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(out):
        assert tcli.main(
            [argv[0], "--no-plotting", "--threads", threads, *argv[1:], EXAMPLE_NPZ, prefix],
            device=device, rng=rng,
        ) == 0
    return (
        pathlib.Path(prefix + ".tsv").read_bytes(),
        pathlib.Path(prefix + ".json").read_bytes(),
        out.getvalue(),
    )


@pytest.mark.parametrize("case", list(CASES))
def test_outputs_do_not_depend_on_threads_or_devices(tmp_path, monkeypatch, case):
    """Each run's table and windows equal the serial run's byte for byte,
    and the counters show the pipelined workers (and, with a device
    list, both devices; with --inter, the tiles of each trans map spread
    over them) ran."""
    argv, runs = CASES[case]
    if case == "inter_tiled":
        monkeypatch.setattr(tcm, "DENSE_LIMIT", 50)
        monkeypatch.setattr(ttiled, "DEFAULT_TILE", 128)
    spreads = []
    on_devices = ttiled._on_devices

    def spy(devices, scan):
        spreads.append(len(devices))
        return on_devices(devices, scan)

    monkeypatch.setattr(ttiled, "_on_devices", spy)
    created = []
    create_mat = ContactMap.create_mat
    monkeypatch.setattr(
        ContactMap, "create_mat", lambda cm: created.append(cm.name) or create_mat(cm)
    )
    MAPS_RUN.clear()
    serial = run(tmp_path, "serial", argv, "1", "cpu")
    assert set(k[0] for k in MAPS_RUN) == {"serial"}
    assert len(serial[0].splitlines()) > 1
    for k, (threads, device) in enumerate(runs):
        MAPS_RUN.clear()
        del spreads[:], created[:]
        got = run(tmp_path, f"run{k}", argv, threads, device)
        assert got[:2] == serial[:2], (threads, device)
        workers = MapScheduler(resolve_devices(device), threads).workers
        used = {key[1] for key in MAPS_RUN}
        assert {key[0] for key in MAPS_RUN} == {"pipelined"}
        assert len(used) >= 2 and used <= set(range(workers))
        if case == "inter_tiled":
            assert spreads and set(spreads) == {2}
        if case == "iterations":
            # two passes over three maps, each map created once
            assert sum(MAPS_RUN.values()) == 6 and sorted(created) == sorted(set(created))


def test_subsample_with_threads_matches_serial(tmp_path):
    """``--subsample 0.8 --threads 3`` draws what ``--threads 1`` draws with
    the same seed: the producer creates the maps in map order."""
    argv = ["detect", "--subsample", "0.8"]
    serial = run(tmp_path, "serial", argv, "1", "cpu", np.random.RandomState(7))
    piped = run(tmp_path, "piped", argv, "3", "cpu", np.random.RandomState(7))
    assert piped[:2] == serial[:2]
    other = run(tmp_path, "other", argv, "3", ["cpu", "cpu"], np.random.RandomState(8))
    assert other[0] != serial[0]


def test_dump_lines_and_files_in_map_order(tmp_path):
    """With ``--dump`` the snapshot lines come out in map order and the
    snapshots are the serial run's."""
    import scipy.sparse as sp

    argv = ["detect", "--max-dist", "60000"]
    serial = run(tmp_path, "serial", [*argv, "--dump", str(tmp_path / "d1")], "1", "cpu")
    piped = run(tmp_path, "piped", [*argv, "--dump", str(tmp_path / "d3")], "3", "cpu")
    assert piped[:2] == serial[:2]
    assert piped[2].replace("d3", "d1") == serial[2] and serial[2].count("Dumping") == 6
    for path in sorted((tmp_path / "d1").iterdir()):
        a, b = sp.load_npz(path), sp.load_npz(tmp_path / "d3" / path.name)
        assert np.array_equal(a.toarray(), b.toarray(), equal_nan=True)


def test_no_map_is_created_twice_at_once(tmp_path, monkeypatch):
    """An instrumented ``create_mat`` (slowed, to widen any overlap) sees
    every creation on one producer, the caller's thread, never two of one
    map at once, and the maps made in map order, one pass after
    another."""
    active, created, threads, lock = {}, [], [], threading.Lock()
    original = ContactMap.create_mat

    def create_mat(self):
        with lock:
            active[self.name] = active.get(self.name, 0) + 1
            assert active[self.name] == 1, f"{self.name} created twice at once"
            threads.append(threading.get_ident())
            created.append(self.name)
        time.sleep(0.05)
        try:
            original(self)
        finally:
            with lock:
                active[self.name] -= 1

    monkeypatch.setattr(ContactMap, "create_mat", create_mat)
    run(tmp_path, "piped", ["detect", "--pattern", "hairpins", "--iterations", "2",
                            "--subsample", "0.9"], "4", ["cpu", "cpu"],
        np.random.RandomState(0))
    # --subsample turns retention off: every pass creates every map again
    assert created == ["chr1-chr1", "chr2-chr2", "chr3-chr3"] * (len(created) // 3)
    assert len(created) >= 3 and set(threads) == {threading.get_ident()}


def bounded(fn, timeout=60):
    """``fn()`` on a thread joined with a timeout: its result, or its
    exception raised here; fails if it has not ended in time."""
    out = {}

    def run():
        try:
            out["result"] = fn()
        except BaseException as exc:  # handed to the test's thread
            out["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout)
    assert not thread.is_alive(), "the scan did not end in time"
    if "error" in out:
        raise out["error"]
    return out["result"]


class FakeMap:
    """What the scheduler reads of a ContactMap."""

    def __init__(self, index, device):
        self.name, self.device = f"m{index}", device
        self.band_dev = self.dense_dev = self.sparse = None

    def create_mat(self):
        self.band_dev = torch.full((4,), float(self.name[1:]))

    def destroy_mat(self):
        self.band_dev = None


def test_scheduler_order_and_counts_under_stress():
    """More workers than cores and a short switch interval: every result
    comes back in order, every map is freed, and the run counter loses no
    update."""
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        devices = [torch.device("cpu")] * 3
        sched = MapScheduler(devices, threads=16)
        assert sched.workers == 18
        maps = [FakeMap(i, devices[i % 3]) for i in range(200)]
        MAPS_RUN.clear()
        out = bounded(
            lambda: list(sched.scan(list(enumerate(maps)), lambda cm: float(cm.band_dev.sum())))
        )
    finally:
        sys.setswitchinterval(before)
    assert out == [4.0 * i for i in range(200)]
    assert sum(MAPS_RUN.values()) == 200 and len(MAPS_RUN) == 18
    assert all(m.band_dev is None for m in maps)
    assert not [t for t in threading.enumerate() if t.name.startswith("map-")]


@pytest.mark.parametrize("where", ["task", "create"])
def test_scheduler_raises_and_stops(where):
    """A failing task or map creation raises from the scan at that map,
    after the maps before it, and leaves no thread behind."""
    devices = [torch.device("cpu")] * 2

    class Broken(FakeMap):
        def create_mat(self):
            if where == "create" and self.name == "m5":
                raise OSError("fetch failed")
            super().create_mat()

    def task(cm):
        if where == "task" and cm.name == "m5":
            raise ValueError("scan failed")
        return cm.name

    maps = [Broken(i, devices[i % 2]) for i in range(12)]
    got = []

    def scan():
        for name in MapScheduler(devices, threads=3).scan(list(enumerate(maps)), task):
            got.append(name)

    with pytest.raises(OSError if where == "create" else ValueError):
        bounded(scan)
    assert got == [f"m{i}" for i in range(5)]
    deadline = time.perf_counter() + 10
    while [t for t in threading.enumerate() if t.name.startswith("map-")]:
        assert time.perf_counter() < deadline
        time.sleep(0.01)


def test_scheduler_rejects_a_map_on_another_device():
    devices = [torch.device("cpu"), torch.device("cpu")]
    maps = [FakeMap(0, torch.device("meta"))]
    with pytest.raises(ValueError, match="its worker"):
        bounded(lambda: list(
            MapScheduler(devices, threads=2).scan(list(enumerate(maps)), lambda cm: 0)
        ))
    with pytest.raises(ValueError, match="at least 1"):
        MapScheduler(devices, threads=0)


def test_retain_maps_budget(monkeypatch):
    """Maps stay created across passes only with several passes, no
    subsample, and device maps within the budget."""
    import chromosight_torch.parallel.scheduler as sched

    from chromosight_torch.io.config import load_kernel_config
    from chromosight_torch.io.source import ArraySource
    from chromosight_torch.runtime.genome import HicGenome

    genome = HicGenome(
        ArraySource.from_npz(EXAMPLE_NPZ), kernel_config=load_kernel_config("loops"), device="cpu"
    )
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()):
        genome.normalize("auto")
        genome.make_sub_matrices()
    assert not retain_maps(genome, 1) and retain_maps(genome, 2)
    monkeypatch.setattr(sched, "RETAIN_BYTES", 1000)
    assert not retain_maps(genome, 2)
    monkeypatch.setattr(sched, "RETAIN_BYTES", 4e9)
    genome.sample = 0.5
    assert not retain_maps(genome, 2)


def test_device_lists_resolve_and_raise_without_a_card(monkeypatch):
    """A device list resolves in order, repeats kept; None and CUDA
    devices raise without a card: no path falls back to the CPU."""
    assert resolve_devices("cpu") == (torch.device("cpu"),)
    assert resolve_devices(["cpu", torch.device("cpu")]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        resolve_devices([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", ["cpu", "cuda:0"]):
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_devices(device)
    with pytest.raises(RuntimeError, match="is_available"):
        tcli.main(["detect", "--no-plotting", EXAMPLE_NPZ, "x"])
