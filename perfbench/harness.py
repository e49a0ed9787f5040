"""The benchmark harness of chromosight_torch: one cell, one run.

A run is one process (``perfbench/run.py``), whose freed memory malloc
keeps for reuse (``keep_freed_memory``):

1. set-up (``setup_s``): the cell's genome drawn on the device from the
   seed (``genome.make_genome``), its cooler file and the traffic's
   inputs written into the cell's cache directory inside the checkout
   unless that seed's files are there (``set_up``), the port imported
   and one warm command run (which builds the port's libraries under
   ``build/chromosight_torch/`` on a checkout's first run);
2. the window: the cell's command run back to back in process through
   ``chromosight_torch.cli.main.main`` until ``--seconds`` have passed
   (the last command runs to its end), under ``torch.profiler`` with
   ``--trace 1``;
3. the check: the last command's table and windows against the plain
   reference of the traffic's check on the same genome and inputs, each
   compared number beside its limit (``check.compare``; limits in the
   cell file);
4. one JSON line, last on standard output.

Everything that belongs to a cell, a configuration, a traffic mix or a
per-layer metric is a file found by its name: ``cells/<cell>.json``
(configuration, traffic, chips, limits), ``configs/<name>.json``,
``traffic/<name>.json`` and ``metrics/<metric>.py``.  A traffic file
gives the command's arguments (``argv``), its pattern and whether it
scans trans maps, and may give:

* ``"inputs": {"<name>": "<maker>"}``: files made from the seed in
  set-up by ``inputs/<maker>.py`` (a ``SUFFIX`` and
  ``make(genome, seed, path)``), kept for their seed like the cooler
  file;
* ``"check": "<name>"``: the check ``checks/<name>.py`` (``KEY``,
  ``VALUES`` and ``reference(...)``, as ``check.py`` has them), in place
  of ``check.py``'s ``detect`` check.

Where ``argv`` holds ``"{map}"``, ``{map}``, ``{prefix}`` and
``{<input name>}`` in it are replaced by the cooler URI, the output
prefix and the inputs' paths; otherwise the command is
``[*argv, <map>, <prefix>]``.  ``BENCHMARK.json`` at the checkout's
root says which metrics a cell reports.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "chromosight_tpu")
PLACEHOLDER = re.compile(r"\{([^{}]*)\}")


def log(msg):
    sys.stderr.write(f"[perfbench] {msg}\n")
    sys.stderr.flush()


def load_json(kind, name):
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    return json.loads(path.read_text())


def load_cell(name):
    """The cell ``cells/<name>.json`` with its configuration and traffic
    loaded under ``config_data`` and ``traffic_data``, its traffic's
    input makers under ``makers`` ({input name: module}) and its check
    under ``checker`` (``check.py`` itself where the traffic names
    none)."""
    from perfbench import check
    from perfbench.genome import load_config

    cell = load_json("cells", name)
    cell["name"] = name
    cell["config_data"] = load_config(cell["config"])
    cell["traffic_data"] = traffic = load_json("traffic", cell["traffic"])
    where = named_by(cell)
    cell["makers"] = {key: load_module("inputs", maker, where)
                      for key, maker in traffic.get("inputs", {}).items()}
    cell["checker"] = load_module("checks", traffic["check"], where) if "check" in traffic else check
    command_argv(cell, "", "", dict.fromkeys(cell["makers"], ""))  # every placeholder known
    return cell


def named_by(cell):
    """The traffic file of ``cell``, for an error about what it names."""
    return f"traffic {cell['traffic']!r} ({HERE / 'traffic' / cell['traffic']}.json)"


def benchmark_spec(root=ROOT):
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def metrics_of(spec, cell, kind):
    """Names of the ``kind`` ("end_to_end" or "per_layer") metrics that
    ``cell`` reports."""
    return [m["name"] for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_module(kind, name, where=None):
    """The module ``<kind>/<name>.py``; a missing one raises
    FileNotFoundError naming it and ``where`` it was asked for."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        asked = f" named by {where}" if where else ""
        raise FileNotFoundError(f"no {kind} module {name!r}{asked} ({path})")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(name):
    """The per-layer metric reader ``metrics/<name>.py``: a module with
    UNIT, LAYER, MOVES and ``read(run)``."""
    return load_module("metrics", name)


def cache_dir(cell):
    """The cell's fixed cache directory inside the checkout."""
    return ROOT / "build" / "perfbench" / cell


def ensure_file(genome, folder, seed):
    """The cooler file of ``genome`` for ``seed`` in the cell's cache
    directory ``folder``, written unless it is there; the files of other
    seeds are removed first, so a cell keeps one.  (path, seconds spent
    writing)."""
    from perfbench import coolwrite

    layout = genome.config["layout"]
    folder.mkdir(parents=True, exist_ok=True)
    path = folder / f"genome-{seed}{layout['suffix']}"
    if path.exists():
        return path, {}
    for old in folder.glob("genome-*"):
        old.unlink()
    t0 = time.perf_counter()
    b1, b2, ct = genome.pixels()
    t1 = time.perf_counter()
    tmp = folder / f"partial{layout['suffix']}"
    coolwrite.write_mcool(tmp, genome.names, genome.lengths, genome.binsize,
                          genome.weights, b1, b2, ct, layout["group"],
                          layout["pixel_rows_per_bin"] * genome.n_bins)
    os.replace(tmp, path)
    return path, {"pixels": t1 - t0, "write": time.perf_counter() - t1}


def ensure_input(genome, folder, seed, name, maker):
    """The input ``name`` of ``seed``, made by ``maker`` in ``folder``
    unless it is there, as ``ensure_file`` keeps the cooler file: (path,
    seconds spent making it, or None where it was kept)."""
    path = folder / f"{name}-{seed}{maker.SUFFIX}"
    if path.exists():
        return path, None
    own = re.compile(rf"{re.escape(name)}--?\d+{re.escape(maker.SUFFIX)}")
    for old in folder.iterdir():
        if own.fullmatch(old.name):
            old.unlink()
    t = time.perf_counter()
    tmp = folder / f"partial-{name}{maker.SUFFIX}"
    maker.make(genome, seed, tmp)
    os.replace(tmp, path)
    return path, time.perf_counter() - t


def set_up(cell, seed, device, devices, cache=None):
    """The set-up that a run and a calibration share: the genome drawn on
    ``device`` from ``seed``, its cooler file and the traffic's inputs
    in ``cache`` (by default ``cache_dir``), then the genome moved to
    the host and the command built for ``devices``.  (genome, command,
    {part: seconds})."""
    import torch

    from perfbench import genome as genome_mod

    parts = {}
    t = time.perf_counter()
    genome = genome_mod.make_genome(cell["config_data"], seed, device)
    parts["generate"] = time.perf_counter() - t
    folder = cache or cache_dir(cell["name"])
    path, written = ensure_file(genome, folder, seed)
    parts.update(written)
    inputs = {}
    for name, maker in cell["makers"].items():
        inputs[name], seconds = ensure_input(genome, folder, seed, name, maker)
        if seconds is not None:
            parts[f"input {name}"] = seconds
    t = time.perf_counter()
    genome.to("cpu")  # the window's peak memory is the port's alone
    if device.type == "cuda":
        torch.cuda.empty_cache()
    parts["to_host"] = time.perf_counter() - t
    command = Command(cell, f"{path}::/{genome.config['layout']['group']}", inputs,
                      devices if device.type == "cuda" else device)
    return genome, command, parts


def command_argv(cell, uri, prefix, inputs):
    """The arguments of ``cell``'s command: its traffic's ``argv`` with
    ``{map}``, ``{prefix}`` and ``{<input name>}`` replaced where it
    holds ``"{map}"``, else ``[*argv, uri, prefix]``."""
    argv = cell["traffic_data"]["argv"]
    if "{map}" not in argv:
        return [*argv, uri, prefix]
    values = {"map": uri, "prefix": prefix, **{k: str(v) for k, v in inputs.items()}}

    def value(match):
        if match[1] not in values:
            raise ValueError(f"{named_by(cell)} names {match[0]}, which is neither "
                             f"{{map}}, {{prefix}} nor one of its inputs {sorted(inputs)}")
        return values[match[1]]

    return [PLACEHOLDER.sub(value, arg) for arg in argv]


class Command:
    """The cell's command through the port's command line, its output
    files under the run's temporary directory, its standard output and
    error kept in memory (the last command's are kept for a failure).
    ``inputs`` ({name: path}) are the traffic's input files."""

    def __init__(self, cell, uri, inputs, device):
        out_dir = pathlib.Path(tempfile.gettempdir()) / f"perfbench-{cell['name']}"
        out_dir.mkdir(parents=True, exist_ok=True)
        self.prefix = str(out_dir / "out")
        self.inputs = inputs
        self.argv = command_argv(cell, uri, self.prefix, inputs)
        self.device = device
        self.last_log = ""

    def __call__(self):
        from chromosight_torch.cli.main import main

        for suffix in (".tsv", ".json"):  # a command that finds nothing writes nothing
            with contextlib.suppress(FileNotFoundError):
                os.unlink(self.prefix + suffix)
        sink = io.StringIO()
        with contextlib.redirect_stdout(sink), contextlib.redirect_stderr(sink):
            rc = main(list(self.argv), device=self.device)
        self.last_log = sink.getvalue()
        if rc not in (None, 0):
            raise RuntimeError(f"{self.argv[0]} exited {rc}")


def read_outputs(prefix):
    """(table, windows) of a command's ``<prefix>.tsv`` and ``.json``;
    (None, None) where the command wrote none (it found no pattern).
    An integer column that holds an empty or ``nan`` field (``quantify``
    prints its bins so where a pair falls outside the map) reads as
    float64 with NaN there."""
    import numpy as np

    if not os.path.exists(prefix + ".tsv"):
        return None, None
    with open(prefix + ".tsv") as handle:
        header = handle.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in handle]
    cols = list(zip(*rows)) if rows else [()] * len(header)
    table = {}
    for name, values in zip(header, cols):
        if name.startswith("chrom"):
            table[name] = np.array(values, dtype=str)
        elif name in ("score", "pvalue", "qvalue") or any(
                v in ("", "nan", "NaN") for v in values):
            table[name] = np.array([float(v) if v else np.nan for v in values])
        else:
            table[name] = np.array(values, dtype=np.int64)
    with open(prefix + ".json") as handle:
        wins = json.load(handle)
    windows = np.array([wins[str(i)] for i in range(len(wins))], dtype=np.float64)
    return table, windows


def card_power_limit():
    """nvidia-smi's "name, power limit" of the first card, or None."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def stage_annotations():
    """Wrap the port's stage timer so that each stage is also a
    ``torch.profiler`` range named ``stage: <name>`` (traced runs only):
    the trace then says what the host was doing in each idle gap."""
    import torch
    from chromosight_torch import observability

    timer = observability.stage

    @contextlib.contextmanager
    def stage(name):
        with torch.profiler.record_function(f"stage: {name}"), timer(name):
            yield

    observability.stage = stage


class Run:
    """What a run's metric readers read: the window's stage seconds and
    command count, the parsed trace (traced runs), the work the band
    kernel's inputs need (from the reference's pass) and the card's
    peaks."""

    def __init__(self, cell, commands, seconds, stages, trace=None, work=None, peaks=None):
        self.cell, self.commands, self.seconds = cell, commands, seconds
        self.stages, self.trace, self.work, self.peaks = stages, trace, work, peaks

    def stage_per_command(self, name):
        if name not in self.stages or not self.commands:
            return None
        return self.stages[name] / self.commands


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden():
    """True, and the modules named on standard error, where this process
    holds JAX or the JAX package (by whole top-level name)."""
    found = forbidden_modules()
    if found:
        log(f"modules of the JAX package loaded in this process: {found}")
    return bool(found)


def keep_freed_memory():
    """Have glibc's malloc keep what this process frees for its later
    allocations: no block is served by a mapping of its own, and the top
    of the heap is never given back.  The port allocates every map's
    decode output afresh (~3.7 GB a genome command); touching those
    pages anew took 4-12 s of system CPU a command on an H100's 8-core
    sandboxed host, swinging from run to run by more than a bound can
    hold, and 0.3 s once they were reused.  True where the C library
    took the settings."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    m_trim_threshold, m_top_pad, m_mmap_max = -1, -2, -4
    return all([mallopt(m_mmap_max, 0), mallopt(m_trim_threshold, -1),
                mallopt(m_top_pad, 1 << 30)])


def parse_args(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, start):
    args = parse_args(argv)
    kept = keep_freed_memory()
    # any kernel cache a library keeps goes to a fixed directory of the
    # checkout, so that only a checkout's first run fills it
    for var, name in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "perfbench" / "caches" / name)
    import torch

    cell = load_cell(args.workload)
    spec = benchmark_spec()
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    devices = [torch.device("cuda", i) for i in range(chips)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"cell {cell['name']} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
        f"card {card_power_limit()}; freed memory kept {kept}")
    return run_cell(cell, spec, args, start, device, devices)


def run_cell(cell, spec, args, start, device, devices, cache=None):
    """Set-up, window, check and result line of one run on ``device``
    (the port's maps on ``devices``), the cooler file and inputs cached
    in ``cache`` (by default ``cache_dir``); the exit code."""
    import torch

    from perfbench import check, trace as trace_mod

    parts = {}
    t = time.perf_counter()
    import chromosight_torch.cli.main  # the port: fails here in a checkout without it

    package = pathlib.Path(chromosight_torch.cli.main.__file__).resolve()
    if ROOT not in package.parents:
        log(f"the port imported from {package}, not from this checkout {ROOT}")
        return 4
    parts["import"] = time.perf_counter() - t
    genome, command, made = set_up(cell, args.seed, device, devices, cache)
    parts.update(made)
    t = time.perf_counter()
    command()
    parts["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - start
    log("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; setup_s {setup_s:.3f} s")

    from chromosight_torch import observability

    if args.trace:
        stage_annotations()
    observability.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    attempted = failed = 0
    error = None
    profiler = trace_mod.start(device) if args.trace else None
    log(f"window opens at {time.time():.3f} (seconds since the epoch)")
    t0 = time.perf_counter()
    ends = []
    while True:
        attempted += 1
        try:
            command()
        except Exception as exc:  # a failed command ends the window
            failed += 1
            error = exc
            break
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    trace = trace_mod.stop(profiler, window_s) if profiler is not None else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    stages = observability.snapshot()[0]
    done = attempted - failed
    log(f"window {window_s:.3f} s, {done} commands, peak {peak} B; commands "
        + " ".join(f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)) + " s; stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(stages.items(), key=lambda kv: -kv[1])[:8]))
    if error is not None:
        log(f"command failed: {error!r}\n{command.last_log[-4000:]}")

    if refuse_forbidden():
        return 3

    checks, work = {}, {}
    correct = error is None
    if error is None:
        genome.to(device)
        table, windows = read_outputs(command.prefix)
        checks, work = check.compare_with_reference(cell, genome, table, windows, device,
                                                     command.inputs)
        correct = all(c["value"] <= c["limit"] for c in checks.values())
    genome = None

    name = cell["name"]
    metrics = {}
    if args.trace:
        run = Run(name, done, window_s, stages, trace, work, check.peaks(device))
        for metric in metrics_of(spec, name, "per_layer"):
            reader = load_metric(metric)
            value = reader.read(run)
            if value is not None:
                metrics[metric] = {"value": value, "unit": reader.UNIT}
    else:
        values = {
            "setup_s": setup_s,
            "peak_device_gib": peak / 2**30,
            cell["command_metric"]: window_s / done if done else None,
        }
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        for metric in metrics_of(spec, name, "end_to_end"):
            if values.get(metric) is not None:
                metrics[metric] = {"value": values[metric], "unit": units[metric]}
    result = {
        "correct": bool(correct),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": len(devices),
            "memory_peak_bytes": int(peak),
        },
    }
    if trace is not None:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["checks"] = checks
    # again once the check and the readers have loaded what they load
    if refuse_forbidden():
        return 3
    for key, c in checks.items():
        log(f"check {key}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
