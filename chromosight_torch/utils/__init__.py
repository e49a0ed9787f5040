"""The reference package's import paths.

The reference exposes its layers under ``chromosight.utils.*``
(``detection``, ``preprocessing``, ``io``, ``stats``, ``plotting``,
``contacts_map``).  The port organises the same functions by tier
(ops / runtime / io / detection), and these aliases let user code written
against the reference paths run unchanged:

.. code-block:: python

    import chromosight_torch.utils.detection as cud
    corr, pvals = cud.normxcorr2(mat, kernel, device="cpu")
"""

import sys

import chromosight_torch.detection as detection
import chromosight_torch.io as io
import chromosight_torch.plotting as plotting
import chromosight_torch.preprocessing as preprocessing
import chromosight_torch.stats as stats
from chromosight_torch import runtime as contacts_map

# importable as submodules (``import chromosight_torch.utils.io``)
sys.modules[__name__ + ".detection"] = detection
sys.modules[__name__ + ".preprocessing"] = preprocessing
sys.modules[__name__ + ".io"] = io
sys.modules[__name__ + ".stats"] = stats
sys.modules[__name__ + ".plotting"] = plotting
sys.modules[__name__ + ".contacts_map"] = contacts_map

__all__ = ["detection", "preprocessing", "io", "stats", "plotting", "contacts_map"]
