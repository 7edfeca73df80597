"""Study: run_own_study's aggregation (every SolutionsTable of the call read
back, results_summary.csv and results_all.csv written) by the program's
span study.aggregate, per experiment written."""

from portbench import spans

LAYER = "study"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    return spans.span_ms_per_experiment(run, "study.aggregate")
