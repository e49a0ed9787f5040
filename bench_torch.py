#!/usr/bin/env python3
"""Genome detect bench of the PyTorch / CUDA port: ONE json line on stdout.

Run from the root of a checkout on a machine with a CUDA card:

    python3 bench_torch.py

It raises without a card.  The workload, the keys of the line and where
they depart from ``bench.py`` are in ``chromosight_torch/bench/detect.py``;
``chromosight_torch.bench.detect.main(device="cpu")`` runs it on the CPU
(with small ``CHROMOSIGHT_BENCH_GENOME_BINS`` / ``_GENOME_CHROMS``).
"""

from chromosight_torch.bench.detect import main

if __name__ == "__main__":
    main()
