"""Device: the share of the traced window in which nothing ran on the card
(one minus the union of device activity over the window)."""

LAYER = "device"
UNIT = "fraction"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
