"""Seconds per command of the port's stages ``genome: open`` (the cooler
file opened, its bin table read), ``genome: normalize`` (the stored
weights taken) and ``genome: maps`` (one map object per chromosome)
together (``cli/main.py``, ``runtime/genome.py``).  None where none of
them ran."""

UNIT = "s"
LAYER = "command line, genome, maps"
MOVES = "genome_cmd_s"
STAGES = ("genome: open", "genome: normalize", "genome: maps")


def read(run):
    parts = [run.stage_per_command(name) for name in STAGES]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
