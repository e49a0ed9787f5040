"""Seconds of the port's stage ``io: fetch+scatter`` per command: the
cooler file's pixel columns read, inflated, unshuffled and scattered into
count bands on the host (``io/hdf5.py``, ``io/source.py``)."""

UNIT = "s"
LAYER = "io"
MOVES = "genome_cmd_s"


def read(run):
    return run.stage_per_command("io: fetch+scatter")
