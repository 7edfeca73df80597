"""Serial assembler: its read simulation and dBG + walk stages, mean per
experiment."""

from portbench import readers

LAYER = "serial assembler"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "experiments_per_s"


def read(run):
    return readers.serial_mean_ms(run, readers.SIMULATE_DBG)
