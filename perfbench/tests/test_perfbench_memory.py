"""A run's process keeps the memory it frees: ``harness.keep_freed_memory``
takes glibc's settings, and afterwards a large block, touched and freed,
stays resident for the process to reuse; without them it goes back."""

import json
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[2]

SCRIPT = textwrap.dedent("""
    import ctypes, json, sys
    sys.path.insert(0, {root!r})
    from perfbench import harness
    kept = harness.keep_freed_memory() if {keep!r} else None
    libc = ctypes.CDLL(None)
    libc.malloc.restype = ctypes.c_void_p
    libc.free.argtypes = [ctypes.c_void_p]
    libc.memset.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t]

    def resident():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * 4096

    size = 256 << 20
    block = libc.malloc(size)
    libc.memset(block, 1, size)
    before = resident()
    libc.free(block)
    print(json.dumps({{"kept": kept, "released": before - resident()}}))
""")


def run(keep):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT), keep=keep)],
                         capture_output=True, text=True, timeout=120, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_freed_memory_is_kept():
    kept, default = run(True), run(False)
    assert kept["kept"] is True
    assert kept["released"] < 16 << 20
    assert default["released"] > 128 << 20
