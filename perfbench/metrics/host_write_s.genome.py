"""Seconds of the port's stage ``host: write`` per command: the table
and the windows written as indented JSON (``cli/main.py``,
``io/writers.py``)."""

UNIT = "s"
LAYER = "finalize and write"
MOVES = "genome_cmd_s"


def read(run):
    return run.stage_per_command("host: write")
