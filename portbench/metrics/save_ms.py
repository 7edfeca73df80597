"""Results: save_result's host milliseconds, the benchmark's own span
around each call, mean per experiment."""

LAYER = "results"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    saves = [e.save_s for e in run.experiments if e.save_s is not None]
    return 1000.0 * sum(saves) / len(saves) if saves else None
