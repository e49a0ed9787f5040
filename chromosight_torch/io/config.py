"""Kernel-configuration loading with json and numpy.

Counterpart of ``chromosight_tpu/io/config.py``.  Presets are the port's
own copies of the JAX package's files, in ``chromosight_torch/kernels/data``.
Configs are validated against the same schema when ``jsonschema`` imports;
the card's machine may not have it, and the port runs without it.
"""

from __future__ import annotations

import json
import pathlib
import sys
from os.path import join

import numpy as np

try:
    from jsonschema import ValidationError, validate
except ImportError:
    validate = None

PRESET_DIR = pathlib.Path(__file__).parents[1] / "kernels" / "data"

# Same content as chromosight_tpu.io.config.KERNEL_SCHEMA (that module
# cannot be imported here: its package loads h5py and pandas).
KERNEL_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "kernels": {
            "type": "array",
            "items": {
                "anyOf": [
                    {"type": "string"},
                    {
                        "type": "array",
                        "items": {
                            "type": "array",
                            "items": {"type": "number"},
                        },
                    },
                ]
            },
        },
        "min_dist": {"type": "number", "minimum": 0},
        "max_dist": {"type": "number", "minimum": 0},
        "max_iterations": {"type": "number", "minimum": 0},
        "min_separation": {"type": "number", "minimum": 1},
        "max_perc_undetected": {"type": "number", "minimum": 0},
        "max_perc_zero": {"type": "number", "minimum": 0},
        "pearson": {"type": "number"},
        "resolution": {"type": "number"},
    },
    "required": [
        "name",
        "kernels",
        "min_dist",
        "max_dist",
        "max_iterations",
        "min_separation",
        "pearson",
        "resolution",
    ],
}


def load_kernel_config(kernel, custom=False):
    """Load a kernel configuration from a preset name or a JSON file path.

    Returns the config dict with ``kernels`` replaced by a list of 2-D
    float64 arrays (matrices inline, or text files relative to the JSON).
    """
    if custom:
        config_path = str(kernel)
    else:
        config_path = join(PRESET_DIR, f"{kernel}.json")
    try:
        with open(config_path, "r") as handle:
            kernel_config = json.load(handle)
    except FileNotFoundError:
        if custom:
            sys.stderr.write(
                f"Error: Kernel configuration file {config_path} does not "
                "exist.\n"
            )
        else:
            sys.stderr.write(
                f"Error: No preset configuration for pattern {kernel}.\n"
            )
        raise
    if validate is not None:
        try:
            validate(kernel_config, KERNEL_SCHEMA)
        except ValidationError:
            sys.stderr.write("Invalid kernel configuration\n")
            raise
    mats = []
    for entry in kernel_config["kernels"]:
        if isinstance(entry, str):
            mats.append(np.loadtxt(join(pathlib.Path(config_path).parent, entry)))
        else:
            mats.append(np.asarray(entry, dtype=np.float64))
    kernel_config["kernels"] = mats
    return kernel_config
