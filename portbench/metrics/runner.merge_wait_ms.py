"""Batched runner: the main thread's wait for the merge worker (its
futs[b].result()) by the program's span runner.merge_wait, per experiment
written: the share of merge_ms that the overlap does not hide."""

from portbench import spans

LAYER = "batched runner"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    return spans.span_ms_per_experiment(run, "runner.merge_wait")
