"""Self seconds of the port's root stage ``command`` per command: the
host time of a command in no other stage, from the port's own account
(``observability.self_seconds()``, which the run's ``stages`` do not
carry; nothing of the port runs between the window and the readers).
None where the port keeps no self time or no ``command`` stage ran."""

UNIT = "s"
LAYER = "command line, genome, maps"
MOVES = "genome_cmd_s"


def read(run):
    from chromosight_torch import observability

    self_seconds = getattr(observability, "self_seconds", None)
    if self_seconds is None or not run.commands:
        return None
    own = self_seconds().get("command")
    return None if own is None else own / run.commands
