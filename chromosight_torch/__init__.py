"""chromosight-torch: the PyTorch / CUDA port of chromosight-tpu.

A second package beside ``chromosight_tpu`` with the same layout
(``io/``, ``ops/``, ``runtime/``, ``cli/``, ``detection.py``).  It imports
``torch`` and never ``jax``; host helpers that load without jax
(``chromosight_tpu.native``, ``.preprocessing``, ``.stats``,
``.ops.balance``, ``.cli.args``, ``.observability``) are reused by import.

The hot spot of the band-engine ``detect`` path, the fused band Pearson
(``chromosight_tpu/ops/pallas_band.py::_fused_kernel`` on the TPU), is a
hand-written CUDA kernel here (``csrc/band_pearson.cu``), built with
``nvcc`` for ``sm_90a`` at first use.  On CPU tensors every op takes its
plain PyTorch version.
"""

__version__ = "0.1.0"

__all__ = ["NotPortedError", "__version__"]


class NotPortedError(NotImplementedError):
    """A feature of chromosight_tpu that this port does not have yet.

    The message names the ``ROADMAP.md`` queue-1 item that ports it."""

    def __init__(self, what, roadmap_item):
        super().__init__(
            f"{what} is not yet ported to chromosight_torch "
            f"(ROADMAP.md, queue 1, item {roadmap_item}); use "
            "chromosight_tpu for it"
        )
