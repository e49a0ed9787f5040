"""chromosight-torch: the PyTorch / CUDA port of chromosight-tpu.

A second package beside ``chromosight_tpu`` with the same layout
(``io/``, ``ops/``, ``runtime/``, ``cli/``, ``detection.py``).  It imports
``torch``, never ``jax``, and nothing of ``chromosight_tpu``: the host
helpers it shares with the JAX package are its own copies (``native``,
``preprocessing``, ``stats``, ``observability``, ``plotting``,
``ops.balance``, ``cli.args`` and the ``kernels/data`` presets).

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
            "chromosight-tpu for it"
        )
