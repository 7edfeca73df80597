"""95th percentile over every experiment of the window of the host time
from run_experiment's call to save_result's return."""

import numpy as np

LAYER = "harness"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    lat = [e.latency_s for e in run.experiments if e.latency_s is not None]
    if not lat:
        return None
    return 1000.0 * float(np.percentile(lat, 95))
