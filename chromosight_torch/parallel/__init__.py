"""The per-chromosome scheduler behind ``--threads`` and several devices.

``MapScheduler`` is the counterpart of ``_Prefetcher`` and
``_scan_submatrices`` (``chromosight_tpu/cli/main.py:274-365``) and of
the data parallelism over maps of ``detect_on_mesh`` and ``auto_mesh``
(``chromosight_tpu/parallel/mesh.py``); ``retain_maps`` of
``_retain_maps`` (:369-406).
"""

from chromosight_torch.parallel.scheduler import (
    MAPS_RUN,
    RETAIN_BYTES,
    MapScheduler,
    destroy_maps,
    retain_maps,
)

__all__ = ["MAPS_RUN", "RETAIN_BYTES", "MapScheduler", "destroy_maps", "retain_maps"]
