"""Seconds per command in which the card sat idle inside the tile scan:
the traced window's idle gaps put down to the stage ``tile scan`` or to
one of its per-batch stages ``tile: scatter``, ``tile: mask``, ``tile:
pearson`` and ``tile: kept`` (``ops/tiled.py``), summed over what the
trace's summary keeps (its ten largest idle labels).  None without a
trace or where no such gap is kept."""

UNIT = "s"
LAYER = "tile scan"
MOVES = "inter_cmd_s"


def read(run):
    if run.trace is None or not run.commands:
        return None
    gaps = [secs for name, secs in run.trace["breakdown"]["idle_gaps"]
            if name == "tile scan" or name.startswith("tile: ")]
    return sum(gaps) / run.commands if gaps else None
