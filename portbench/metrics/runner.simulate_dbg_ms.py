"""Batched runner: its read simulation and dBG + walk stages, per
experiment written."""

from portbench import readers

LAYER = "batched runner"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    return readers.study_ms_per_experiment(run, readers.SIMULATE_DBG_BATCHED)
