"""chromosight-torch: the PyTorch / CUDA port of chromosight-tpu.

A second package beside ``chromosight_tpu`` with the same layout
(``io/``, ``ops/``, ``runtime/``, ``parallel/``, ``cli/``,
``detection.py``) and the same command line: ``detect``, ``quantify``,
``generate-config``, ``list-kernels`` and ``test``.  It imports
``torch``, never ``jax``, and nothing of ``chromosight_tpu``: the host
helpers it shares with the JAX package are its own copies (``native``,
``preprocessing``, ``stats``, ``observability``, ``plotting``,
``ops.balance``, ``cli.args``, ``cli/logo.txt`` and the ``kernels/data``
presets).

The hot spot of the band-engine ``detect`` path, the fused band Pearson
(``chromosight_tpu/ops/pallas_band.py::_fused_kernel`` on the TPU), is a
hand-written CUDA kernel here (``csrc/band_pearson.cu``), built with
``nvcc`` for ``sm_90a`` at first use.  On CPU tensors every op takes its
plain PyTorch version.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
