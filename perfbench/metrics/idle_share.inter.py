"""Share of the traced window in which the card ran no kernel, memcpy or
memset, in percent: 100 (1 - busy / window), busy the union of those
intervals in the profiler's trace."""

UNIT = "%"
LAYER = "device"
MOVES = "inter_cmd_s"


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
