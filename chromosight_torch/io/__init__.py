"""IO layer: the .cool reader and writer (on the port's own HDF5 reader
and writer, ``io.hdf5``), contact sources, kernel-config loading, bed2d
parsing, pattern and window writers and the terminal progress bar.

The exports of ``chromosight_tpu/io/__init__.py`` (the reference
``chromosight/utils/io.py``).
"""

from chromosight_torch.io.bed2d import load_bed2d
from chromosight_torch.io.config import KERNEL_SCHEMA, load_kernel_config
from chromosight_torch.io.cool import CoolFile, create_cool, load_cool
from chromosight_torch.io.writers import (
    check_prefix_dir,
    download_file,
    progress,
    save_windows,
    write_patterns,
)

__all__ = [
    "CoolFile",
    "load_cool",
    "create_cool",
    "load_kernel_config",
    "KERNEL_SCHEMA",
    "load_bed2d",
    "write_patterns",
    "save_windows",
    "check_prefix_dir",
    "download_file",
    "progress",
]
