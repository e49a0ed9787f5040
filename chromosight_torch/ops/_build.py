"""Build and load the port's CUDA kernels.

``chromosight_torch/csrc/*.cu`` are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, under
``build/chromosight_torch/<hash>/`` at the repository root, at first use.
The hash covers the sources and the command line, so an edited source
rebuilds.  The library is loaded with ``ctypes``; callers declare each
entry's argument types.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).parents[2] / "build" / "chromosight_torch"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    # no implicit mul+add contraction: the Pearson algebra then rounds op
    # for op as its plain PyTorch twin does (explicit fma() stays fused)
    "-fmad=false",
    "-Xptxas=-v",
    # optimise the template instances on all host cores at once
    "-split-compile=0",
]

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO = {}  # seconds, log (nvcc/ptxas output) and path of the build


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "chromosight_torch cannot be built"
    )


def load():
    """The loaded kernel library, building it first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        sources = sorted(CSRC.glob("*.cu"))
        nvcc = _nvcc()
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        out_dir = BUILD_DIR / digest.hexdigest()[:16]
        lib_path = out_dir / "libchromosight_torch.so"
        t0 = time.perf_counter()
        log = ""
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"tmp{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, lib_path)
        _LIB = ctypes.CDLL(str(lib_path))
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0, log=log, path=str(lib_path)
        )
        return _LIB
