"""Measurement scripts of the port: the counterparts of the JAX system's
``bench.py`` and its ``tools/`` benches.

* ``genome``: the synthetic bench genome written as a ``.cool`` with its
  ``.truth.bed2d`` of planted loops, cached under
  ``CHROMOSIGHT_BENCH_CACHE`` (``tools/make_synthetic_cool.py``,
  ``bench.py:ensure_genome``);
* ``baseline``: the CPU baselines ``vs_baseline`` divides by (the
  reference's own sparse engine where ``CHROMOSIGHT_REFERENCE_DIR``
  names its tree, else the same-math reimplementation of ``bench.py``);
* ``detect``: the one-JSON-line genome detect bench (``bench.py``; run
  as ``python3 bench_torch.py`` from the root of a checkout);
* ``quantify``: quantify of the planted loops, twice
  (``tools/bench_quantify.py``);
* ``inter``: ``detect --inter`` on the trans genome, one line a rep
  (``tools/measure_inter.py``);
* ``baseline_configs``: the eight BASELINE rows
  (``tools/run_baseline_configs.py``).

Each drives the port's command line (``chromosight_torch.cli.main.main``)
on the card, the CPU only when the caller passes ``device="cpu"``, and
names the device its line ran on with ``device_name``.
"""


def device_name(devices):
    """"cpu", or the first card's ``torch.cuda.get_device_name``, for the
    resolved device list ``devices``."""
    import torch

    return "cpu" if devices[0].type != "cuda" else torch.cuda.get_device_name(devices[0])
