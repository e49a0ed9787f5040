"""Seconds of the port's stage ``io: scatter`` per command: the pixels
read scattered into packed count bands (or trans triplets) on the host
(``io/source.py``); inside ``io: fetch+scatter``.  None where the stage
did not run."""

UNIT = "s"
LAYER = "io"
MOVES = "genome_cmd_s"


def read(run):
    return run.stage_per_command("io: scatter")
