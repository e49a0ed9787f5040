#!/usr/bin/env python3
"""Compare the CUDA band Pearson of two checkouts of chromosight_torch on
one CUDA card: kernel-only time at the three shapes of PERF.md, and the
registers and spills ptxas reports for each instance.

Run from the root of a checkout, on a machine with a CUDA card, with
another checkout (for example the parent commit unpacked by
``git archive``) in a directory that ``.gitignore`` lists:

    python3 compare_kernels.py build/parent

It draws chr1 of the synthetic 13 x 48,000-bin genome of ``chip_smoke.py``
once, with this checkout, and saves the framed inputs the main path gives
the kernel: loops (one 17x17 kernel, 418 diagonals) and borders (three
17x17 kernels, 19 diagonals).  Then each checkout, in a process of its
own, in the order other, this, this, other, builds its kernel library and
times ``band_pearson`` on those inputs: loops K = 1 and borders K = 3 at
48,000 x 418 (the loops band) and borders K = 3 at 48,000 x 19, each as
the device time of the kernels whose name holds ``band_pearson_tiled``
in a torch.profiler trace of REPS calls after a warm one, ROUNDS times.
Each process prints one JSON line; the last line is the medians per
checkout.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

BINSIZE = 5000
REPS = 10
ROUNDS = 3
ORDER = ("other", "this", "this", "other")
MISSING_TOL, PEARSON = 0.5, 0.3


def frame_inputs(path):
    """chr1's framed loops and borders inputs, saved to ``path``."""
    import numpy as np
    import torch

    from chromosight_torch.detection import frame_contact_map
    from chromosight_torch.io.config import load_kernel_config
    from chromosight_torch.io.source import ArraySource
    from chromosight_torch.runtime.genome import HicGenome

    source = ArraySource.from_synthetic(13, 48_000, seed=0, binsize=BINSIZE)
    cases = {}
    for preset in ("loops", "borders"):
        cfg = load_kernel_config(preset)
        genome = HicGenome(source, kernel_config=cfg, device="cuda")
        genome.normalize("auto")
        genome.make_sub_matrices()
        cm = genome.sub_mats.contact_map[0]
        cm.create_mat()
        sig_p, mask_p = frame_contact_map(cm, np.shape(cfg["kernels"][0]))
        cases[preset] = {"sig_p": sig_p.cpu(), "mask_p": mask_p.cpu(),
                         "n": cm.shape[0], "max_dist": int(cm.max_dist),
                         "band": tuple(cm.band_dev.shape)}
        cm.destroy_mat()
    torch.save(cases, path)


def ptxas_lines(log):
    """Registers and spills of each kernel instance in an nvcc -Xptxas -v
    log: {instance: [lines]}."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"band_pearson_tiledILi(\d+)ELi(\d+)E", line)
            entry = found and f"{found.group(1)}x{found.group(1)} W={found.group(2)}"
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


def run(package_dir, inputs):
    """Time the kernel of ``package_dir`` on the saved inputs."""
    sys.path.insert(0, os.path.abspath(package_dir))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chromosight_torch
    from chromosight_torch.io.config import load_kernel_config
    from chromosight_torch.ops import _build
    from chromosight_torch.ops.band_pearson import band_pearson

    here = os.path.dirname(os.path.abspath(chromosight_torch.__file__))
    assert here.startswith(os.path.abspath(package_dir)), here
    cases = torch.load(inputs)
    loops = np.asarray(load_kernel_config("loops")["kernels"][0])
    borders = np.stack(load_kernel_config("borders")["kernels"])
    shapes = {"loops K=1 418": ("loops", loops), "borders K=3 418": ("loops", borders),
              "borders K=3 19": ("borders", borders)}
    _build.load()
    out = {"package": package_dir, "ptxas": ptxas_lines(_build.BUILD_INFO.get("log", "")),
           "ms": {}, "band": {}}
    for name, (case, kernels) in shapes.items():
        c = cases[case]
        sig_p, mask_p = c["sig_p"].cuda(), c["mask_p"].cuda()
        out["band"][name] = c["band"]

        def call():
            return band_pearson(sig_p, mask_p, kernels, c["n"], c["max_dist"], MISSING_TOL,
                                PEARSON)

        call()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(ROUNDS):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    call()
                torch.cuda.synchronize()
            us = sum(e.device_time_total for e in prof.key_averages()
                     if "band_pearson_tiled" in e.key)
            rounds.append(us / REPS / 1e3)
        out["ms"][name] = rounds
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3])
        return
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_kernels: torch.cuda.is_available() is False")
    other = sys.argv[1]
    inputs = os.path.join(tempfile.mkdtemp(), "inputs.pt")
    frame_inputs(inputs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    times = {"other": {}, "this": {}}
    for which in ORDER:
        res = subprocess.run(
            [sys.executable, __file__, "--run", other if which == "other" else ".", inputs],
            capture_output=True, text=True, timeout=1200)
        if res.returncode != 0:
            sys.exit(f"compare_kernels: {which} failed\n{res.stderr[-3000:]}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        for name, rounds in json.loads(line)["ms"].items():
            times[which].setdefault(name, []).extend(rounds)
    medians = {w: {k: statistics.median(v) for k, v in t.items()} for w, t in times.items()}
    print(json.dumps({"card": card, "kernel_only_ms_median": medians, "other": other}))


if __name__ == "__main__":
    main()
