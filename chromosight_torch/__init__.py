"""chromosight-torch: the PyTorch / CUDA port of chromosight-tpu.

A second package beside ``chromosight_tpu`` with the same layout, the
same command line (``detect``, ``quantify``, ``generate-config``,
``list-kernels`` and ``test``) and the same Python API.  It imports
``torch``, never ``jax``, and nothing of ``chromosight_tpu``: the host
helpers it shares with the JAX package are its own copies.

The hot spot of the band-engine ``detect`` path, the fused band Pearson
(``chromosight_tpu/ops/pallas_band.py::_fused_kernel`` on the TPU), is a
hand-written CUDA kernel here (``csrc/band_pearson.cu``), built with
``nvcc`` for ``sm_90a`` at first use.  On CPU tensors every op takes its
plain PyTorch version.  The entry points run on the CUDA cards unless the
caller asks for the CPU (``device="cpu"``).

Public API, the reference package's layout:

* ``chromosight_torch.kernels`` (alias ``models``) - preset pattern
  configurations, ``kernels.loops`` ... and ``kernels.kernel_names``
* ``chromosight_torch.detection`` - normxcorr2 / xcorr2 / pick_foci /
  pattern_detector / ...
* ``chromosight_torch.preprocessing`` - detrend / distance_law / ...
* ``chromosight_torch.io`` - cool reader and writer, config loader,
  writers
* ``chromosight_torch.runtime`` - HicGenome / ContactMap runtime classes
* ``chromosight_torch.stats``, ``chromosight_torch.plotting``
* ``chromosight_torch.utils`` - the reference's ``chromosight.utils.*``
  import paths
"""

from chromosight_torch.version import __version__

__all__ = ["__version__"]
