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
           of G: one breakscore and one random pass over [G, S] solution
           rows, KS in chunks of KS_ROWS rows, and one Myers kernel call a
           member against its own segment

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

from genomeassembler_dev_tpu_torch.core.encoding import INVALID, encode_dna
from genomeassembler_dev_tpu_torch.core.querytable import (
    TOTAL, QueryTable, load_default_query_table)
from genomeassembler_dev_tpu_torch.dbg.assemble import contigs_from_read_codes_batched
from genomeassembler_dev_tpu_torch.merge.engine import assemble_solutions
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev_tpu_torch.ops.ks import batched_ks_2samp
from genomeassembler_dev_tpu_torch.pipeline.assembler import (
    Assembler, ExperimentResult, experiment_stats, pack_strings, pad_reads, random_scores,
    solution_columns)
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
from genomeassembler_dev_tpu_torch.pipeline.velvet import EVAL_BUDGET_BYTES
from genomeassembler_dev_tpu_torch.score.breakscore import BreakScores, breakscore
from genomeassembler_dev_tpu_torch.sim.reads import ReadSet, dedup_reads, generate_reads
from genomeassembler_dev_tpu_torch.utils.profiling import annotate, count, tracing
from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

KS_ROWS = 256  # solution rows one KS pooled sort takes


def simulate_batch(cfg: ExperimentConfig, genome: torch.Tensor, table: QueryTable) -> ReadSet:
    """Stage 1: the reads of every segment of genome [B, L]. The generator is
    seeded with cfg.seed, as Assembler.simulate reseeds it before every
    experiment, so each segment's reads equal its serial run's."""
    gen = torch.Generator(device=genome.device)
    gen.manual_seed(cfg.seed)
    return generate_reads(gen, genome, table, cfg.read_len, cfg.coverage_target, cfg.kmer)


def group_size(score_group: int, rows: int, width: int, n_reads: int, track_len: int) -> int:
    """Members of one score group, each of at most `rows` solution rows of
    `width` columns and `n_reads` distinct reads: at most score_group, and
    few enough that the group stays under EVAL_BUDGET_BYTES. A row takes
    four float32 [TOTAL] matrices (counts, normalised counts, path_freq,
    the random pass's) and ~64 bytes a window and a read (the matcher's
    keys, sort and break sites); one KS chunk takes its pooled sort, ~40
    bytes an entry (values, two weights, the order, two float64 sums)."""
    row_bytes = 16 * TOTAL + 64 * (width + n_reads)
    ks_bytes = 40 * KS_ROWS * (TOTAL + track_len)
    return max(1, min(score_group, (EVAL_BUDGET_BYTES - ks_bytes) // (row_bytes * rows)))


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
            # members share S (so each one's score dots take its serial call's
            # shape, see score/breakscore.py::dot_f32); widths and reads pad
            with annotate("eval.pack"):
                G = len(members)
                S = packed[members[0]][0].shape[0]
                L = max(packed[b][0].shape[1] for b in members)
                U = max(packed[b][2].shape[0] for b in members)
                pm_np = np.full((G, S, L), INVALID, np.uint8)
                pl_np = np.zeros((G, S), np.int32)
                rc = torch.zeros((G, U, cfg.read_len), dtype=torch.uint8, device=device)
                rn = torch.zeros((G, U), dtype=torch.int32, device=device)
                rv = torch.zeros((G, U), dtype=torch.bool, device=device)
                for gi, b in enumerate(members):
                    pmat, plens, rcodes, rcounts, rvalid = packed[b]
                    pm_np[gi, : pmat.shape[0], : pmat.shape[1]] = pmat
                    pl_np[gi, : plens.shape[0]] = plens
                    rc[gi, : rcodes.shape[0]] = rcodes
                    rn[gi, : rcounts.shape[0]] = rcounts
                    rv[gi, : rvalid.shape[0]] = rvalid
                pm = torch.from_numpy(pm_np).to(device)
                pl = torch.from_numpy(pl_np).to(device)
            if tracing():
                count("eval.bases", int(pl_np.sum()))
                count("eval.cells", pm_np.size)
            with annotate("eval.breakscore"):
                bs = score_rows(pm, pl, rc, rn, rv, table.combined, break_kmer=cfg.kmer)
            with annotate("eval.random"):
                rand, rand_nb, rand_nl = random_scores(bs, pl, uniform)
            with annotate("eval.ks"):
                # KS in chunks of rows, each row against its own segment's track
                path_freq = bs.path_freq.view(G * S, TOTAL)
                row_seg = torch.tensor(members, device=device).repeat_interleave(S)
                ks = torch.cat([batched_ks_2samp(path_freq[lo : lo + KS_ROWS],
                                                 rs.track[row_seg[lo : lo + KS_ROWS]])
                                for lo in range(0, G * S, KS_ROWS)]).view(G, S)
            with annotate("eval.levenshtein"):
                # one Myers kernel call a member, against its own segment
                lev = torch.stack([batched_levenshtein_auto(pm[gi], pl[gi], genome[b],
                                                            mode="NW")
                                   for gi, b in enumerate(members)])
            with annotate("eval.readback"):
                host = {name: t.cpu().numpy() for name, t in (
                    ("bp", bs.bp_score), ("bp_nb", bs.bp_score_norm_by_break_freqs),
                    ("bp_nl", bs.bp_score_norm_by_len), ("breaks", bs.kmer_breaks),
                    ("lev", lev), ("ks", ks), ("rand", rand), ("rand_nb", rand_nb),
                    ("rand_nl", rand_nl))}
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
                    pmat, plens = pack_strings(solutions[b], s_multiple=64, l_multiple=128)
                    uniq, counts = dedup_reads(rs.codes[b], rs.valid[b])
                    packed[b] = (pmat, plens) + pad_reads(uniq, counts, cfg.read_chunk)
                S = pmat.shape[0]
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
