"""Seconds of the port's stage ``write: windows`` per command: the
windows written as indented JSON (``io/writers.py:save_windows``);
inside ``host: write``.  None where the stage did not run."""

UNIT = "s"
LAYER = "finalize and write"
MOVES = "genome_cmd_s"


def read(run):
    return run.stage_per_command("write: windows")
