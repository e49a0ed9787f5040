"""Preset pattern configurations (``data/*.json``).

The port's copies of the seven presets of ``chromosight_tpu/kernels/data``,
byte for byte, read by ``chromosight_torch.io.config.load_kernel_config``.
``kernel_names`` lists them in the order of ``chromosight_tpu.kernels
.kernel_names`` (sorted file names); a preset is loaded when asked for,
not when this module is imported.
"""

import pathlib

DATA_DIR = pathlib.Path(__file__).parent / "data"


def kernel_names():
    """The preset names, sorted."""
    return sorted(p.stem for p in DATA_DIR.glob("*.json"))
