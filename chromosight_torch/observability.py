"""Tracing, per-stage timing, link bytes and per-program cost accounting.

The port's counterpart of ``chromosight_tpu/observability.py``, with its
names, dict keys, report format and environment variables:

* ``stage(name)`` - context manager recording wall time per pipeline
  stage (``device.stage`` wraps it with a device synchronise);
* ``add_bytes(channel, n)`` - bytes crossing the host-device link
  ("upload", "download"), counted on the CPU path too;
* ``record_band_upload(name, ...)`` and ``band_uploads()`` - the form
  each band map's upload took (packed counts or the float32 band);
* ``account_dispatch(name, cost, *args, **kwargs)`` and
  ``compute_snapshot()`` - logical FLOPs and HBM byte bounds per program
  family, from a cost function kept next to the program it describes
  (evaluated once per shape, when a snapshot asks for it);
* ``plain_cost(fn, ...)`` - the FLOPs and bytes of a plain PyTorch
  function at its arguments' shapes, run on the ``meta`` device;
* ``device_peaks()`` - the card's peak FLOP/s and memory rate, for MFU
  and roofline shares;
* ``report(file)`` - the stage and compute summary, printed at exit when
  CHROMOSIGHT_TPU_TIMINGS is set (and not ``0``);
* ``maybe_trace()`` - a ``torch.profiler`` trace of the block, written
  TensorBoard-readable into CHROMOSIGHT_TPU_PROFILE=<dir> when it is set.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_STAGE_TOTALS = defaultdict(float)
_STAGE_COUNTS = defaultdict(int)
_BYTE_TOTALS = defaultdict(int)
# map name -> {"mode", "exceptions", "shape"} of its last band upload
_BAND_UPLOADS = {}
# Per-program-family compute accounting (MFU / roofline): dispatches per
# (family, shape signature), and per signature its cost, or the cost
# function and shape stand-ins of its arguments until a snapshot or the
# report asks for it (see account_dispatch).
_DISPATCHES = defaultdict(int)
_COST_CACHE = {}
_ENABLED = os.environ.get("CHROMOSIGHT_TPU_TIMINGS", "") not in ("", "0")
# stages, bytes and dispatches are recorded from worker threads too (the
# scheduler's map workers, the tiled engine's device threads, the ICE
# block pool); += on a dict slot is not atomic
_LOCK = threading.Lock()

# Public peak rates by card name, (FLOP/s, memory bytes/s).  The H100
# SXM's FLOP/s is the float64 tensor-core peak (132 SMs x 128 FMA per
# clock x 1.98 GHz = 3.345e13 FMA/s), the rate the band kernel's bound
# in PERF.md is taken at; its memory rate is the data sheet's 3.35 TB/s.
PEAKS = {"NVIDIA H100 80GB HBM3": (66.9e12, 3.35e12)}


def add_bytes(channel, n):
    """Account bytes crossing the host<->device link (upload/download), so
    benchmarks can attribute link time = bytes / measured bandwidth even
    when transfers are enqueued asynchronously."""
    with _LOCK:
        _BYTE_TOTALS[channel] += int(n)


def record_band_upload(name, mode, exceptions, shape):
    """Record the form of map ``name``'s band upload: ``mode`` "u4", "u8"
    or "u16" (packed raw counts, with ``exceptions`` counts that did not
    fit their lane) or "f32" (the host-scattered float32 band), and the
    (rows, width) ``shape`` of the band it gave."""
    with _LOCK:
        _BAND_UPLOADS[name] = {"mode": mode, "exceptions": int(exceptions),
                               "shape": tuple(shape)}


def band_uploads():
    """{map name: {"mode", "exceptions", "shape"}} of the band uploads
    since the last ``reset`` (a copy)."""
    with _LOCK:
        return {name: dict(rec) for name, rec in _BAND_UPLOADS.items()}


def snapshot():
    """(stage_totals, stage_counts, byte_totals) copies for benchmarks."""
    with _LOCK:
        return dict(_STAGE_TOTALS), dict(_STAGE_COUNTS), dict(_BYTE_TOTALS)


def reset():
    """Clear accumulated stage, byte, band-upload and compute counters."""
    with _LOCK:
        for totals in (_STAGE_TOTALS, _STAGE_COUNTS, _BYTE_TOTALS, _BAND_UPLOADS, _DISPATCHES):
            totals.clear()


def _arg_sig(x, keep_scalars=False):
    """Cache-key signature of one argument.

    Tensors and arrays key on (shape, dtype).  Bare positional ints and
    floats are dropped by default: at the instrumented sites those are
    logical row counts, scan distances and thresholds, whose value does
    not change a program's cost; keying on them would recount once per
    chromosome.  Kwargs keep their scalars."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ("arr", tuple(x.shape), str(x.dtype))
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return x
    if isinstance(x, (int, float)):
        return x if keep_scalars else ("scalar",)
    if isinstance(x, (tuple, list)):
        return tuple(_arg_sig(v, keep_scalars=True) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _arg_sig(v, keep_scalars=True)) for k, v in x.items()))
    return repr(x)


class _Pending:
    """A cost not evaluated yet: its function and the arguments, tensors
    replaced by empty ``meta`` stand-ins of their shapes and dtypes (no
    data is kept alive)."""

    def __init__(self, cost, args, kwargs):
        import torch
        from torch.utils._pytree import tree_map

        def stand_in(x):
            if isinstance(x, torch.Tensor):
                return torch.empty(x.shape, dtype=x.dtype, device="meta")
            return x

        self.cost = cost
        self.args, self.kwargs = tree_map(stand_in, (args, kwargs))

    def evaluate(self):
        """(flops, hbm_min_bytes, hbm_unfused_bytes); zeros where the cost
        function fails: accounting never breaks a run."""
        try:
            return tuple(float(v) for v in self.cost(*self.args, **self.kwargs))
        except Exception:
            return (0.0, 0.0, 0.0)


def _program_cost(key):
    """(flops, hbm_min_bytes, hbm_unfused_bytes) per dispatch of a shape
    signature, evaluated at its first request and cached."""
    with _LOCK:
        entry = _COST_CACHE[key]
    if isinstance(entry, _Pending):
        entry = entry.evaluate()
        with _LOCK:
            _COST_CACHE[key] = entry
    return entry


def account_dispatch(name, cost, *args, **kwargs):
    """Record one dispatch of a program family.

    Call next to the actual dispatch with the arguments ``cost`` reads.
    ``cost(*args, **kwargs)`` returns (logical FLOPs as the plain version
    writes the function, the bytes of its inputs and outputs, the bytes
    of the plain version's inputs and intermediates) from the arguments'
    shapes.  The dispatch costs a signature and a count: the cost is
    evaluated once per shape signature, when ``compute_snapshot`` or the
    report first needs it (on shape stand-ins of the arguments), so a run
    that reads no snapshot pays nothing for it."""
    key = (name, tuple(_arg_sig(a) for a in args), _arg_sig(kwargs, keep_scalars=True))
    with _LOCK:
        _DISPATCHES[key] += 1
        known = key in _COST_CACHE
    if not known:
        pending = _Pending(cost, args, kwargs)
        with _LOCK:
            _COST_CACHE.setdefault(key, pending)


def compute_snapshot():
    """Per-program-family compute totals for benchmarks / rooflines.

    Returns a dict name -> {flops, hbm_min_bytes, hbm_unfused_bytes,
    dispatches}."""
    with _LOCK:
        counts = dict(_DISPATCHES)
    out = {}
    for key, n in counts.items():
        flops, hbm_min, hbm_unfused = _program_cost(key)
        rec = out.setdefault(key[0], {"flops": 0.0, "hbm_min_bytes": 0.0,
                                      "hbm_unfused_bytes": 0.0, "dispatches": 0})
        rec["flops"] += n * flops
        rec["hbm_min_bytes"] += n * hbm_min
        rec["hbm_unfused_bytes"] += n * hbm_unfused
        rec["dispatches"] += n
    return out


def plain_cost(fn, *args, **kwargs):
    """(FLOPs, bytes) of ``fn`` run operation by operation on the ``meta``
    device, its tensor arguments replaced by empty ones of their shapes
    and dtypes (no data is read or computed): the bytes of its tensor
    inputs plus those of every tensor an operation writes (views write
    none), what an unfused execution moves at least; and the FLOPs, 2 m n
    k per matrix product, 2 per multiply-add of a convolution, and one
    per element of every other operation (of its input for a reduction).
    Cost functions use it for ``hbm_unfused_bytes``."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves, tree_map

    def nbytes(t):
        return t.numel() * t.element_size()

    matmuls = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default}
    totals = {"flops": 0, "bytes": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view:
                return out
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            totals["bytes"] += sum(nbytes(t) for t in outs)
            if func in matmuls:
                totals["flops"] += 2 * outs[0].numel() * ins[0].shape[-1]
            elif func is torch.ops.aten.convolution.default:
                weight = ins[1]
                totals["flops"] += 2 * outs[0].numel() * weight[0].numel()
            else:
                totals["flops"] += max((t.numel() for t in ins + outs), default=0)
            return out

    def meta(x):
        if isinstance(x, torch.Tensor):
            totals["bytes"] += nbytes(x)
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x

    args, kwargs = tree_map(meta, (args, kwargs))
    with Count():
        fn(*args, **kwargs)
    return totals["flops"], totals["bytes"]


def device_peaks(device=None):
    """(peak_flops_per_s, peak_memory_bytes_per_s, label) of ``device``
    (None: the first CUDA card, where there is one), for MFU and
    bandwidth-utilization reporting.

    On the CPU: (None, None, "cpu").  On a card the label is its
    ``torch.cuda.get_device_name`` and the peaks come from ``PEAKS``;
    CHROMOSIGHT_TPU_PEAK_TFLOPS and CHROMOSIGHT_TPU_PEAK_HBM_GBPS override
    them.  A card missing from the table, with no override, gets None
    peaks: no guess."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None, None, "cpu"
    label = torch.cuda.get_device_name(device)
    flops, rate = PEAKS.get(label, (None, None))
    if os.environ.get("CHROMOSIGHT_TPU_PEAK_TFLOPS"):
        flops = float(os.environ["CHROMOSIGHT_TPU_PEAK_TFLOPS"]) * 1e12
    if os.environ.get("CHROMOSIGHT_TPU_PEAK_HBM_GBPS"):
        rate = float(os.environ["CHROMOSIGHT_TPU_PEAK_HBM_GBPS"]) * 1e9
    return flops, rate, label


@contextmanager
def stage(name):
    """Accumulate wall-clock time for a named pipeline stage."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _STAGE_TOTALS[name] += dt
            _STAGE_COUNTS[name] += 1


def report(file=None):
    """The stage timings, then the compute accounting per program family,
    in the JAX package's format (nothing before any stage ran)."""
    file = file or sys.stderr
    stages, counts, _ = snapshot()
    if not stages:
        return
    file.write("\n-- chromosight-torch stage timings --\n")
    for name, total in sorted(stages.items(), key=lambda kv: -kv[1]):
        file.write(f"  {name:<28} {total:8.3f}s  ({counts[name]} calls)\n")
    compute = compute_snapshot()
    if compute:
        file.write("-- compute accounting (per program family) --\n")
        for name, rec in sorted(compute.items(), key=lambda kv: -kv[1]["flops"]):
            file.write(
                f"  {name:<28} {rec['flops'] / 1e12:8.3f} TFLOP  "
                f"{rec['hbm_min_bytes'] / 1e9:8.3f} GB io-min  "
                f"({rec['dispatches']} dispatches)\n"
            )


if _ENABLED:
    atexit.register(report)


@contextmanager
def maybe_trace():
    """A ``torch.profiler`` trace of the block (the CPU, and the card where
    there is one), written TensorBoard-readable into the directory
    CHROMOSIGHT_TPU_PROFILE names; without it, nothing (torch.profiler is
    not imported)."""
    trace_dir = os.environ.get("CHROMOSIGHT_TPU_PROFILE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield
