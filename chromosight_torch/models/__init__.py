"""Model family registry: an alias of :mod:`chromosight_torch.kernels`.

In a template-matching framework the "models" are the pattern kernels:
each family (loops, borders, hairpins, centromeres, stripes) is a set of
template matrices plus its detection parameters.  So
``chromosight_torch.models.loops`` and ``chromosight_torch.kernels.loops``
are the same object.
"""

import sys

import chromosight_torch.kernels as _kernels

sys.modules[__name__] = _kernels
