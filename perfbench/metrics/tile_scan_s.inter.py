"""Seconds of the port's stage ``tile scan`` per command: the trans maps'
halo tiles correlated on the card (``ops/tiled.py``)."""

UNIT = "s"
LAYER = "tile scan"
MOVES = "inter_cmd_s"


def read(run):
    return run.stage_per_command("tile scan")
