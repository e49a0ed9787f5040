"""Preset pattern-kernel library.

Each built-in pattern (loops, borders, hairpins, centromeres, stripes,
...) is a module-level dict loaded by
``chromosight_torch.io.config.load_kernel_config`` from the port's copies
of the JAX package's presets (``data/*.json``, byte for byte): the keys of
the JSON config, with ``kernels`` holding the template matrices as 2-D
numpy arrays, as in the reference ``chromosight.kernels``
(``kernels/__init__.py:29-44`` of the reference).  ``kernel_names`` lists
them in sorted file order:

.. code-block:: python

    import chromosight_torch.kernels as ck
    kernel = ck.loops["kernels"][0]
    names = ck.kernel_names
"""

import pathlib
import sys

from chromosight_torch.io.config import load_kernel_config

_current_module = sys.modules[__name__]
DATA_DIR = pathlib.Path(__file__).parent / "data"

kernel_names = []
for _cfg_file in sorted(DATA_DIR.glob("*.json")):
    setattr(_current_module, _cfg_file.stem, load_kernel_config(_cfg_file.stem, custom=False))
    kernel_names.append(_cfg_file.stem)
