"""Device: torch.cuda.max_memory_allocated over the window, in GiB. It
moves experiments/s through batch_runner.group_size's memory cap on score
groups."""

LAYER = "device"
UNIT = "GiB"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**30
