"""Set-up seconds: imports, the CUDA context, the query table on the card,
the kernels' and native engine's loads (their builds on a checkout's first
run), the cell's segments and one warm-up unit a row."""

LAYER = "harness"
UNIT = "s"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    return run.setup_s
