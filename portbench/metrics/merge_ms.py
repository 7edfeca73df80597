"""Merge: the ordering-ensemble merge's seconds per experiment. Batched
study: the worker thread's merges, per experiment written; serial: the
merge stage, mean per experiment."""

from portbench import readers

LAYER = "merge"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    if run.calls:
        return readers.study_ms_per_experiment(run, (readers.MERGE_WORKER,))
    return readers.serial_mean_ms(run, (readers.MERGE,))
