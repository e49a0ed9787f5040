"""Seconds of the port's stage ``io: decode`` per command: the cooler
file's compressed chunks inflated (or szip-decoded) and unshuffled on the
host's threads, and edge chunks decoded one by one (``io/hdf5.py``);
inside ``io: fetch+scatter``.  None where the stage did not run."""

UNIT = "s"
LAYER = "io"
MOVES = "genome_cmd_s"


def read(run):
    return run.stage_per_command("io: decode")
