"""Evaluation: the share of the scored [S, L] solution cells that hold a
real base (the program's counters eval.bases over eval.cells, summed over
every scoring call of the window; a group's members each count its padded
shape)."""

from portbench import spans

LAYER = "evaluation"
UNIT = "fraction"
SOURCE = "program_counter"
BETTER = "higher"
MOVES = "experiments_per_s"


def read(run):
    bases, cells = spans.counter(run, "eval.bases"), spans.counter(run, "eval.cells")
    if not bases or not cells:
        return None
    return bases / cells
