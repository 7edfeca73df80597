"""Batched multi-segment experiments (mirrors
genomeassembler_dev_tpu/pipeline/batch_runner.py) on an explicit device.

The serial Assembler launches one experiment's device operations one by one
from Python, one experiment after another. Here the device stages run across
a batch of B segments of one length:

  stage 1: one simulation of every segment's reads               [B, N, R]
  stage 2: one dBG over the batch (the disjoint union of the segments'
           graphs) and one doubling walk
  stage 3: each segment's ordering-ensemble merge, on one worker thread
  stage 4: segments with the same padded solution count S scored in groups
           of G by pipeline/evaluate.py::evaluate_group: one breakscore and one
           random pass over [G, S] solution rows, KS in chunks of KS_ROWS
           rows, and one Myers kernel call a member against its own segment

Stages 3 and 4 overlap: the worker merges segment b + 1 ... while the main
thread packs and scores finished segments (the native merge's ctypes call
releases the GIL). Each segment's result equals Assembler.run_experiment on
it; only the schedule changes. Left out from the JAX runner: its background
compile pool, the fused eval program (GA_FUSED_EVAL), the relay retry, and its
walk and dedup capacity checks (eager arrays are sized exactly).

With a mesh (parallel/mesh.py), each rank runs stages 1-4 on its `seg` block
of the batch; with a `read` axis above 1 the breakscore goes through
parallel/sharding.py::make_breakscore_step (reads over `read`, table rows
over `tp`); every rank then returns the whole batch's results, gathered over
`seg`.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
from genomeassembler_dev_tpu_torch.core.querytable import QueryTable, load_default_query_table
from genomeassembler_dev_tpu_torch.dbg.assemble import contigs_from_read_codes_batched
from genomeassembler_dev_tpu_torch.merge.engine import assemble_solutions
from genomeassembler_dev_tpu_torch.pipeline.assembler import (
    Assembler, ExperimentResult, experiment_stats)
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
from genomeassembler_dev_tpu_torch.pipeline.evaluate import (
    evaluate_group, group_size, pack_member, solution_columns)
from genomeassembler_dev_tpu_torch.score.breakscore import BreakScores, breakscore
from genomeassembler_dev_tpu_torch.sim.reads import ReadSet, generate_reads
from genomeassembler_dev_tpu_torch.utils.profiling import annotate
from genomeassembler_dev_tpu_torch.utils.timers import StageTimer


def simulate_batch(cfg: ExperimentConfig, genome: torch.Tensor, table: QueryTable) -> ReadSet:
    """Stage 1: the reads of every segment of genome [B, L]. The generator is
    seeded with cfg.seed, as Assembler.simulate reseeds it before every
    experiment, so each segment's reads equal its serial run's."""
    gen = torch.Generator(device=genome.device)
    gen.manual_seed(cfg.seed)
    return generate_reads(gen, genome, table, cfg.read_len, cfg.coverage_target, cfg.kmer)


def run_experiments_batched(
    cfg: ExperimentConfig,
    segments: list[str],
    device,
    table: QueryTable | None = None,
    uniform: QueryTable | None = None,
    score_group: int = 8,
    verbose: bool = False,
    mesh=None,
) -> list[ExperimentResult]:
    """One ExperimentResult per segment, as Assembler(cfg, device,
    table).run_experiment(segment) gives it. Segments must share one
    length. With a DeviceMesh of (seg, read, tp) every rank of it calls this
    with the same segments, whose count must divide by the seg axis, and
    gets the same list back."""
    cfg = cfg.validate()
    device = torch.device(device)
    table = table if table is not None else load_default_query_table(device)
    if cfg.traversal != "standard":
        # the batched walk is the standard traversal's: any other runs the
        # serial Assembler, so a biased config never yields standard results
        # (the mesh does not apply)
        asm = Assembler(cfg, device, table, verbose=verbose)
        return [asm.run_experiment(s) for s in segments]
    if mesh is None:
        return _run_standard(cfg, segments, device, table, uniform, score_group, verbose,
                             breakscore)
    from genomeassembler_dev_tpu_torch.parallel.mesh import axis_group, axis_size, block
    from genomeassembler_dev_tpu_torch.parallel.sharding import make_breakscore_step

    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    score_rows = breakscore
    if axis_size(mesh, "read") > 1:
        step = make_breakscore_step(mesh["read", "tp"])

        def score_rows(pm, pl, rc, rn, rv, probs, break_kmer):
            return BreakScores(**step(pm, pl, rc, rn, rv, probs))
    local = _run_standard(cfg, segments[block(len(segments), mesh, "seg")], device, table,
                          uniform, score_group, verbose, score_rows)
    group = axis_group(mesh, "seg")
    if group is None:
        return local
    parts = [None] * axis_size(mesh, "seg")
    dist.all_gather_object(parts, local, group=group)
    return [res for part in parts for res in part]


def _run_standard(cfg: ExperimentConfig, segments: list[str], device: torch.device,
                  table: QueryTable, uniform: QueryTable | None, score_group: int,
                  verbose: bool, score_rows) -> list[ExperimentResult]:
    """The standard traversal's batch on one rank; `score_rows` is
    breakscore or the read-sharded step."""
    if not segments:
        return []
    if len({len(s) for s in segments}) != 1:
        raise ValueError("the segments of one batch must share one length")
    with annotate("runner.setup"):
        uniform = uniform if uniform is not None else QueryTable.uniform(device)
        timer = StageTimer(device, verbose)
        B = len(segments)
        genome_np = np.stack([encode_dna(s) for s in segments])
        genome = torch.from_numpy(genome_np).to(device)

    with timer.stage("Generating sequencing reads (batched)"):
        rs = simulate_batch(cfg, genome, table)
    with timer.stage("Running DBG de novo genome assembler (batched)"):
        contig_sets = contigs_from_read_codes_batched(rs.codes, rs.valid, cfg.dbg_kmer,
                                                      cfg.contig_cap)
    with annotate("runner.n_reads"):
        n_reads = rs.valid.sum(dim=1).tolist()

    solutions: list[list[str]] = [[] for _ in range(B)]
    packed: list[tuple] = [()] * B  # (pmat, plens) on the host, reads on the device
    columns: list[dict] = [{} for _ in range(B)]

    def merge(contigs):
        with annotate("runner.merge"):
            t0 = time.perf_counter()
            sols = assemble_solutions(contigs, cfg.dbg_kmer, cfg.seed, cfg.n_orderings,
                                      backend=cfg.merge_backend, device=device)
            return sols, time.perf_counter() - t0

    def cap(members: list[int]) -> int:
        return group_size(score_group, max(packed[b][0].shape[0] for b in members),
                          max(packed[b][0].shape[1] for b in members),
                          max(packed[b][2].shape[0] for b in members), rs.track.shape[-1])

    def score(members: list[int]) -> None:
        with timer.stage("Evaluating each de novo assembled solution (grouped)"):
            host = evaluate_group([packed[b] for b in members], genome, rs.track, table,
                                  uniform, cfg.kmer, segs=members, score_rows=score_rows)
            with annotate("eval.columns"):
                for gi, b in enumerate(members):
                    columns[b] = solution_columns(solutions[b], packed[b][1],
                                                  {name: a[gi] for name, a in host.items()},
                                                  cfg.seq_len)

    merge_seconds = 0.0
    pending: dict[int, list[int]] = {}  # open score groups by solution rows S
    with timer.stage("Merging + evaluating solutions (overlapped)"):
        pool = ThreadPoolExecutor(max_workers=1)
        try:
            futs = [pool.submit(merge, c) for c in contig_sets]
            for b in range(B):
                with annotate("runner.merge_wait"):
                    solutions[b], secs = futs[b].result()
                merge_seconds += secs
                with annotate("runner.pack"):
                    packed[b] = pack_member(solutions[b], rs.codes[b], rs.valid[b],
                                            cfg.read_chunk)
                S = packed[b][0].shape[0]
                # a member that would push its group over the cap opens the next
                if len(pending.get(S, [])) >= cap(pending.get(S, []) + [b]):
                    score(pending.pop(S))
                group = pending.setdefault(S, [])
                group.append(b)
                if len(group) >= cap(group):
                    score(pending.pop(S))
            for group in pending.values():
                score(group)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    # the merges' own time on the worker, inside the overlapped stage
    timer.times["Merging shuffled contig orderings (worker thread)"] = merge_seconds

    with annotate("runner.results"):
        return [ExperimentResult(columns=columns[b],
                                 stats=experiment_stats(cfg, segments[b], genome_np[b],
                                                        n_reads[b]),
                                 timings=dict(timer.times))
                for b in range(B)]
