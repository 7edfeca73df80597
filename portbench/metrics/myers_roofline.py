"""Levenshtein kernel (K1, csrc/myers.cu): the least time the card could
take for every K1 call of the traced window, over K1's device time in the
trace. The bound counts 32-bit word steps from the real solution lengths
of each call (filler runs of a batch included) against the segment's
length, so it reads the same work whatever implements it."""

from portbench.roofline import lev_words_bound_ms

LAYER = "Levenshtein kernel"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "experiments_per_s"
KERNEL = "myers_kernel"


def read(run):
    if run.trace is None:
        return None
    k1_s = run.trace.device_seconds(KERNEL)
    if k1_s <= 0:
        return None
    n = run.config["experiment"]["seq_len"]
    bound_ms = 0.0
    if run.calls:
        for call in run.calls:
            by_ind = {e.ind: e for e in call.experiments}
            for head in call.batch_heads:
                bound_ms += call.fillers[head] * lev_words_bound_ms(
                    run.solution_lengths(by_ind[head]), n)
            bound_ms += sum(lev_words_bound_ms(run.solution_lengths(e), n)
                            for e in call.experiments)
    else:
        bound_ms = sum(lev_words_bound_ms(run.solution_lengths(e), n)
                       for e in run.experiments)
    return 100.0 * bound_ms / (1000.0 * k1_s)
