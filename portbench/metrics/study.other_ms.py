"""Study: a call's host seconds minus its batches' StageTimer
seconds (each batch once), per experiment written: artifact writes,
packing, the aggregation and the study loop's own host work."""

from portbench import readers

LAYER = "study"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    if not run.calls:
        return None
    stages = readers.SIMULATE_DBG_BATCHED + (readers.OVERLAPPED,)
    other = sum(c.seconds - readers.batch_seconds(run, c, stages) for c in run.calls)
    return 1000.0 * other / sum(len(c.experiments) for c in run.calls)
