"""Batched runner: the main thread's packing of each merged segment
(pack_strings, dedup_reads, pad_reads) by the program's span runner.pack,
per experiment written (fillers count for nothing)."""

from portbench import spans

LAYER = "batched runner"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    return spans.span_ms_per_experiment(run, "runner.pack")
