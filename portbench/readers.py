"""Arithmetic that several metric readers share: the program's StageTimer
seconds, as the window's stats JSONs carry them, summed per batch or per
experiment. A batched study call's experiments each carry their whole
batch's times, so a batch is counted once, by its first experiment."""

from __future__ import annotations

SIMULATE_DBG_BATCHED = ("Generating sequencing reads (batched)",
                        "Running DBG de novo genome assembler (batched)")
OVERLAPPED = "Merging + evaluating solutions (overlapped)"
EVALUATE_GROUPED = "Evaluating each de novo assembled solution (grouped)"
MERGE_WORKER = "Merging shuffled contig orderings (worker thread)"
SIMULATE_DBG = ("Generating sequencing reads", "Running DBG de novo genome assembler")
MERGE = "Merging shuffled contig orderings"
EVALUATE = "Evaluating each de novo assembled solution"


def batch_seconds(run, call, stages) -> float:
    """Seconds of `stages` over the call's batches."""
    heads = {e.ind: e for e in call.experiments}
    return sum(run.timings(heads[h]).get(s, 0.0) for h in call.batch_heads for s in stages)


def study_ms_per_experiment(run, stages) -> float | None:
    """Milliseconds of `stages` over every call's batches, per experiment
    written."""
    if not run.calls:
        return None
    total = sum(batch_seconds(run, c, stages) for c in run.calls)
    return 1000.0 * total / sum(len(c.experiments) for c in run.calls)


def serial_mean_ms(run, stages) -> float | None:
    """Mean milliseconds of `stages` over the experiments of a serial run."""
    if run.calls or not run.experiments:
        return None
    return 1000.0 * sum(sum(run.timings(e).get(s, 0.0) for s in stages)
                        for e in run.experiments) / len(run.experiments)
