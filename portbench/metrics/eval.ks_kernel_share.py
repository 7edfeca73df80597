"""Evaluation: the share of the solution rows given a KS statistic that the
KS kernel K4 took (the program's counters eval.ks_kernel_rows over
eval.ks_rows, summed over every scoring call of the window); the rest took
the pooled sort. A program without the counters reads nothing."""

from portbench import spans

LAYER = "evaluation"
UNIT = "fraction"
SOURCE = "program_counter"
BETTER = "higher"
MOVES = "experiments_per_s"


def read(run):
    rows = spans.counter(run, "eval.ks_rows")
    if not rows:
        return None
    return (spans.counter(run, "eval.ks_kernel_rows") or 0) / rows
