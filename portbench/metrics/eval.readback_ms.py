"""Evaluation: the host's wait for the queued evaluation and its copy to
the host (the .cpu().numpy() of every score) by the program's span
eval.readback, per experiment written."""

from portbench import spans

LAYER = "evaluation"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    return spans.span_ms_per_experiment(run, "eval.readback")
