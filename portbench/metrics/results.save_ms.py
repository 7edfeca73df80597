"""Results: save_result's host milliseconds by the program's own span
(results.save, inside pipeline/results.py::save_result), per experiment
written. save_ms times the same calls from outside, in the serial cell."""

from portbench import spans

LAYER = "results"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    return spans.span_ms_per_experiment(run, "results.save")
