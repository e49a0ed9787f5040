"""Per-stage wall-time counters.

The port's copy of the stage timers of ``chromosight_tpu/observability.py``
(``stage``, ``reset``, ``snapshot`` and the counters they keep), without
the JAX program-cost accounting.  ``device.stage`` wraps ``stage`` with a
device synchronise.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_STAGE_TOTALS = defaultdict(float)
_STAGE_COUNTS = defaultdict(int)
_BYTE_TOTALS = defaultdict(int)
# stages are recorded from worker threads too (the ICE block pool);
# += on a dict slot is not atomic
_LOCK = threading.Lock()


def snapshot():
    """(stage_totals, stage_counts, byte_totals) copies for benchmarks."""
    return dict(_STAGE_TOTALS), dict(_STAGE_COUNTS), dict(_BYTE_TOTALS)


def reset():
    """Clear accumulated stage and byte counters."""
    _STAGE_TOTALS.clear()
    _STAGE_COUNTS.clear()
    _BYTE_TOTALS.clear()


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
