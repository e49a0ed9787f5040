"""Run a task on every map of a genome, on one or several devices.

``MapScheduler(devices, threads)`` has ``workers`` per-map workers:
``threads`` rounded up to a multiple of the device count.  Worker k owns
device ``k % len(devices)`` and, on a card, a CUDA stream of its own; map
i goes to worker ``i % workers``, so it runs on the device its genome
gave it (``HicGenome``: map i on device ``i % len(devices)``).  A card may
appear twice: two workers then share it, each on its stream.

* One worker (``--threads 1`` on one device, the default) is the serial
  loop: create, run, free, one map after the other, on the caller's
  thread.  There is no environment variable: ``--threads 1`` is serial.
* Otherwise the caller's thread is the producer: it creates the maps,
  in map order (fetch, scatter, upload and preprocess, on a stream of its
  own per card, synchronised before the map is handed over), and the
  worker threads run the task.  (The host scatter, most of a map's
  creation, ran ~2x slower on a thread of its own than on the main
  thread of an H100 host: ``PERF.md``.)  A map is created only once its worker has finished
  its previous map, so at most ``workers`` maps are alive: ``threads - 1``
  maps of lookahead on one device.  Only the producer creates maps, so no
  map is ever created on two threads at once (the reference's race at
  ``chromosight_tpu/cli/main.py:337-347`` cannot happen), and the
  ``--subsample`` draws come in map order.
* Results, and the ``--dump`` lines a map's creation and task print,
  come out in map order, whatever the workers and devices.

A worker synchronises its stream before it frees a map, so memory that
the map's tensors held on the producer's stream is reused only after
the worker's reads of it.

Two stages say where a pipelined scan waits: ``schedule: producer
wait``, the producer blocked on a busy worker, and ``schedule: result
wait``, the caller blocked on the next map's result.
"""

from __future__ import annotations

import queue
import threading
from collections import Counter
from concurrent.futures import Future, wait

import chromosight_torch.runtime.contact_map as contact_map
from chromosight_torch import observability
from chromosight_torch.device import new_stream, on_stream
from chromosight_torch.runtime.dump import collect

# Bytes of device maps kept created across the passes of a run
# (``retain_maps``): the band tensors of a human 5 kb genome take ~1.3 GB.
RETAIN_BYTES = 4e9
# Maps run since the last clear, by (path, worker, device): path
# "serial" or "pipelined".  Updated under _LOCK.
MAPS_RUN = Counter()
_LOCK = threading.Lock()


def _record(path, worker, device):
    with _LOCK:
        MAPS_RUN[(path, worker, str(device))] += 1


def _created(cm):
    return cm.band_dev is not None or cm.dense_dev is not None or cm.sparse is not None


def retain_maps(genome, n_passes):
    """Whether the genome's maps stay created across ``n_passes`` passes
    instead of being fetched and uploaded again each pass: more than one
    pass, no ``--subsample`` (each pass draws anew, as the reference
    does) and the device maps within ``RETAIN_BYTES``.  Sparse trans maps
    live in host memory and do not count."""
    if n_passes <= 1 or genome.sample is not None:
        return False
    total = 0
    for cm in genome.sub_mats.contact_map:
        n1, n2 = cm.shape
        if cm.is_banded:
            total += n1 * (cm.keep_distance + 1) * 4
        elif max(n1, n2) <= contact_map.DENSE_LIMIT:
            total += n1 * n2 * 8
    return total <= RETAIN_BYTES


def destroy_maps(genome):
    """Free every map of the genome."""
    for cm in genome.sub_mats.contact_map:
        cm.destroy_mat()


class MapScheduler:
    """Per-map workers over ``devices`` (module docstring)."""

    def __init__(self, devices, threads=1):
        self.devices = tuple(devices)
        n_dev = len(self.devices)
        if not n_dev:
            raise ValueError("no device given")
        threads = int(threads)
        if threads < 1:
            raise ValueError(f"--threads must be at least 1, got {threads}")
        self.workers = n_dev * -(-threads // n_dev)

    def scan(self, items, task, keep=False):
        """Yield ``task(cm)`` for each ``(index, cm)`` of ``items`` (index:
        the map's position in its genome), in order.  Each map is created
        first unless it already is, and freed after its task unless
        ``keep``."""
        if self.workers == 1:
            return self._serial(items, task, keep)
        return self._pipelined(list(items), task, keep)

    def _serial(self, items, task, keep):
        for _, cm in items:
            if not _created(cm):
                cm.create_mat()
            try:
                result = task(cm)
            finally:
                if not keep:
                    cm.destroy_mat()
            _record("serial", 0, cm.device)
            yield result

    def _pipelined(self, items, task, keep):
        n_workers = self.workers
        futures = [Future() for _ in items]
        logs = [[] for _ in items]
        inbox = [queue.SimpleQueue() for _ in range(n_workers)]
        stop = threading.Event()

        def work(k):
            device = self.devices[k % len(self.devices)]
            stream = new_stream(device)
            with on_stream(device, stream):
                while (pos := inbox[k].get()) is not None:
                    cm = items[pos][1]
                    result = error = None
                    try:
                        if stop.is_set():
                            raise RuntimeError("scan stopped")
                        with collect(logs[pos]):
                            result = task(cm)
                    except BaseException as exc:
                        error = exc
                    finally:
                        if stream is not None:
                            stream.synchronize()
                        if not keep:
                            cm.destroy_mat()
                    _record("pipelined", k, device)
                    if error is None:
                        futures[pos].set_result(result)
                    else:
                        futures[pos].set_exception(error)

        def emit(pos):
            with observability.stage("schedule: result wait"):
                result = futures[pos].result()
            for line in logs[pos]:
                print(line)
            return result

        workers = [
            threading.Thread(target=work, args=(k,), name=f"map-worker-{k}", daemon=True)
            for k in range(n_workers)
        ]
        for thread in workers:
            thread.start()
        streams, last, done = {}, [None] * n_workers, 0
        try:
            for pos, (index, cm) in enumerate(items):
                k = index % n_workers
                if cm.device != self.devices[k % len(self.devices)]:
                    raise ValueError(f"map {cm.name} is on {cm.device}, its worker on "
                                     f"{self.devices[k % len(self.devices)]}")
                if last[k] is not None:
                    with observability.stage("schedule: producer wait"):
                        wait([last[k]])
                while done < pos and futures[done].done():
                    yield emit(done)
                    done += 1
                try:
                    if not _created(cm):
                        if cm.device not in streams:
                            streams[cm.device] = new_stream(cm.device)
                        stream = streams[cm.device]
                        with on_stream(cm.device, stream), collect(logs[pos]):
                            cm.create_mat()
                            if stream is not None:
                                stream.synchronize()
                except BaseException:
                    # the maps before this one come out first
                    while done < pos:
                        yield emit(done)
                        done += 1
                    raise
                last[k] = futures[pos]
                inbox[k].put(pos)
            while done < len(items):
                yield emit(done)
                done += 1
        finally:
            stop.set()
            for box in inbox:
                box.put(None)
            for thread in workers:
                thread.join()
