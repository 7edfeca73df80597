"""Experiments whose results were written, over the wall seconds of the
window (whole calls until --seconds had passed). Fillers count for
nothing."""

LAYER = "harness"
UNIT = "experiments/s"
SOURCE = "host_clock"
BETTER = "higher"


def read(run):
    return len(run.experiments) / run.window_s
