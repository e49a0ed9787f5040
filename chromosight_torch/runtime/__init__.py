"""Contact-map runtime: whole-genome bookkeeping and one map per
chromosome pair, mirroring the reference ``utils/contacts_map.py``."""

from chromosight_torch.runtime.dump import DumpMatrix
from chromosight_torch.runtime.contact_map import ContactMap
from chromosight_torch.runtime.genome import HicGenome

__all__ = ["DumpMatrix", "ContactMap", "HicGenome"]
