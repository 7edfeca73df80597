"""Command-line interface of the port (mirrors genomeassembler_dev_tpu/cli.py).

  python -m genomeassembler_dev_tpu_torch.cli run        # one experiment
  python -m genomeassembler_dev_tpu_torch.cli study-own  # scripts/02 (grid x iters)
  python -m genomeassembler_dev_tpu_torch.cli study-all  # 02 -> 01 -> 03
  python -m genomeassembler_dev_tpu_torch.cli study-kmer-count  # scripts/01
  python -m genomeassembler_dev_tpu_torch.cli study-gc   # scripts/03
  python -m genomeassembler_dev_tpu_torch.cli study-velvet  # scripts/00
  python -m genomeassembler_dev_tpu_torch.cli study-plots STUDY_DIR...  # a study's figures
  python -m genomeassembler_dev_tpu_torch.cli fit-model     # distil the table into the MLP
  python -m genomeassembler_dev_tpu_torch.cli bench-scaling # sim+count step vs device count

Segments come from --segments-fasta (the reference's SampledRefGenome
contract) or a seeded synthetic store (--synthetic). Everything runs on
--device (default cuda; it takes the place of the JAX CLI's --platform);
without a card the port stops rather than run on the CPU, which has to be
asked for with --device cpu. --plots on run, study-own and study-all draws
each experiment's diagnostics (matplotlib; without it the command stops
before any experiment). study-plots reads a study's CSVs and touches no
device. bench-scaling runs on the ranks that torchrun started, or else on a
one-rank group of its own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_common(p):
    p.add_argument("--workdir", default="./workdir")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--seq-len", type=int, default=1000)
    p.add_argument("--read-len", type=int, default=12)
    p.add_argument("--dbg-kmer", type=int, default=9)
    p.add_argument("--kmer", type=int, default=8)
    p.add_argument("--coverage", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--n-orderings", type=int, default=10000)
    p.add_argument("--traversal", default="standard",
                   choices=["standard", "biased"],
                   help="biased = probability-guided branch continuation")
    p.add_argument("--biased-max-solutions", type=int, default=256,
                   help="keep the longest N biased assemblies as solutions")
    p.add_argument("--segments-fasta", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="use a seeded synthetic segment store")
    p.add_argument("--repeat-segments", action="store_true",
                   help="plant segmental duplications in synthetic segments "
                        "(repeat structure like real genomic sequence)")
    p.add_argument("--total-iters", type=int, default=10)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--plots", action="store_true",
                   help="emit per-experiment diagnostic plots "
                        "(probability track, breakpoint histogram, "
                        "score-vs-Levenshtein boxplots)")


def _add_study(p):
    p.add_argument("--grid", default=None,
                   help="comma list of read_len:dbg_kmer pairs, e.g. 12:9,14:9")
    p.add_argument("--batched", action="store_true",
                   help="run the device stages batched across segments "
                        "(identical outputs; no read FASTAs are written)")
    p.add_argument("--seg-batch", type=int, default=16,
                   help="segments per batch with --batched")


def _device(args):
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here "
                         "(pass --device cpu to run on the CPU)")
    return dev


def _segments(args):
    from genomeassembler_dev_tpu_torch.sim.segments import (
        SegmentStore, synthetic_segment_store)

    if args.segments_fasta:
        return SegmentStore.load(args.segments_fasta)
    return synthetic_segment_store(
        args.seed, args.seq_len, args.total_iters,
        repeats=getattr(args, "repeat_segments", False))


def _config(args, **over):
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig

    return ExperimentConfig(
        seq_len=args.seq_len, read_len=args.read_len, dbg_kmer=args.dbg_kmer,
        kmer=args.kmer, coverage_target=args.coverage, seed=args.seed,
        n_orderings=args.n_orderings,
        traversal=getattr(args, "traversal", "standard"),
        biased_max_solutions=getattr(args, "biased_max_solutions", 256),
    ).with_(**over)


def _grid(args):
    if not args.grid:
        return None
    return tuple(tuple(int(x) for x in pair.split(":")) for pair in args.grid.split(","))


def _own_study(args, dev):
    from genomeassembler_dev_tpu_torch.pipeline.experiments import run_own_study

    return run_own_study(
        args.workdir, _segments(args), dev, base=_config(args), grid=_grid(args),
        total_iters=args.total_iters, verbose=args.verbose,
        batched=args.batched, seg_batch=args.seg_batch, plots=args.plots,
    )


def cmd_run(args):
    from genomeassembler_dev_tpu_torch.pipeline import results as res_io
    from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
    from genomeassembler_dev_tpu_torch.pipeline.experiments import emit_experiment_plots
    from genomeassembler_dev_tpu_torch.utils.plots import require_matplotlib

    if args.plots:
        require_matplotlib()
    dev = _device(args)
    segs = _segments(args)
    cfg = _config(args)
    asm = Assembler(cfg, dev, verbose=args.verbose)
    res = asm.run_experiment(segs.seqs[args.ind - 1])
    path = res_io.save_result(args.workdir, args.ind, cfg, res)
    out = {"solutions": res.n_solutions, "csv": path,
           "stats": {k: v for k, v in res.stats.items() if k != "genome_seq"}}
    if args.plots:
        out["plots"] = emit_experiment_plots(args.workdir, args.ind, asm, res,
                                             segs.seqs[args.ind - 1])
    print(json.dumps(out))


def cmd_study_own(args):
    rep = _own_study(args, _device(args))
    print(json.dumps({"summary": rep.summary_path, "all": rep.all_path,
                      "ran": rep.n_experiments, "skipped": rep.n_skipped}))


def cmd_study_all(args):
    """scripts/submit.sh contract: study 02 (own) -> 01 (kmer count) ->
    03 (GC), one command, shared workdir (run_genomeassembler_dev.sh:8-9)."""
    from genomeassembler_dev_tpu_torch.pipeline.experiments import (
        run_gc_study, run_kmer_count_study)

    dev = _device(args)
    rep = _own_study(args, dev)
    segs = _segments(args)
    r2 = run_kmer_count_study(args.workdir, segs.seqs[0], dev, base=_config(args))
    gc_csv = run_gc_study(args.workdir, segs, _config(args), args.total_iters)
    print(json.dumps({
        "own": {"summary": rep.summary_path, "all": rep.all_path,
                "ran": rep.n_experiments, "skipped": rep.n_skipped},
        "kmer_count_r_squared": {str(k): v for k, v in r2.items()},
        "gc_csv": gc_csv,
    }))


def cmd_study_velvet(args):
    """scripts/00: contigs from --contigs-dir (contigs_exp_<i>.fa), else
    from velveth/velvetg on PATH, else stop."""
    from genomeassembler_dev_tpu_torch.pipeline.experiments import run_velvet_study
    from genomeassembler_dev_tpu_torch.pipeline.velvet import IndustryAssembler
    from genomeassembler_dev_tpu_torch.sim.segments import read_fasta

    if args.contigs_dir:
        def source(asm, segment, ind):
            path = os.path.join(args.contigs_dir, f"contigs_exp_{ind}.fa")
            return list(read_fasta(path).values())
    elif IndustryAssembler.velvet_available():
        def source(asm, segment, ind):
            import torch

            from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
            from genomeassembler_dev_tpu_torch.sim.reads_io import save_read_fastas
            from genomeassembler_dev_tpu_torch.utils.timers import StageTimer

            rs = asm.simulate(torch.from_numpy(encode_dna(segment)).to(asm.device),
                              StageTimer(asm.device, verbose=False))
            p1, p2, _ = save_read_fastas(
                args.workdir, ind, asm.config, rs.codes.cpu().numpy(),
                rs.valid.cpu().numpy(), rs.positions.cpu().numpy(), segment)
            return asm.run_velvet(p1, p2, os.path.join(args.workdir, "velvet", f"exp_{ind}"))
    else:
        raise SystemExit("study-velvet needs --contigs-dir (contigs_exp_<i>.fa files) "
                         "or velveth/velvetg on PATH")

    dev = _device(args)
    rep = run_velvet_study(args.workdir, _segments(args), source, dev,
                           base=_config(args, industry_standard=True), grid=_grid(args),
                           total_iters=args.total_iters, verbose=args.verbose)
    print(json.dumps({"summary": rep.summary_path, "all": rep.all_path,
                      "ran": rep.n_experiments, "skipped": rep.n_skipped}))


def cmd_study_kmer_count(args):
    from genomeassembler_dev_tpu_torch.pipeline.experiments import run_kmer_count_study

    dev = _device(args)
    r2 = run_kmer_count_study(args.workdir, _segments(args).seqs[0], dev,
                              base=_config(args))
    print(json.dumps({"r_squared": {str(k): v for k, v in r2.items()}}))


def cmd_study_gc(args):
    from genomeassembler_dev_tpu_torch.pipeline.experiments import run_gc_study

    out = run_gc_study(args.workdir, _segments(args), _config(args), args.total_iters)
    print(json.dumps({"csv": out}))


def cmd_study_plots(args):
    from genomeassembler_dev_tpu_torch.utils.plots import study_plots

    made = []
    for d in args.study_dirs:
        made += study_plots(d, top_frac=args.top_frac)
    print(json.dumps({"figures": made}))


def cmd_fit_model(args):
    from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
    from genomeassembler_dev_tpu_torch.models import breakage_model as bm

    dev = _device(args)
    params, losses = bm.fit_to_table(
        load_default_query_table(dev), k=args.kmer, steps=args.steps, hidden=args.hidden,
        lr=args.lr, seed=args.seed, device=dev)
    bm.save_params(args.out, params)
    print(json.dumps({"checkpoint": args.out,
                      "loss_first": float(losses[0]),
                      "loss_last": float(losses[-1])}))


def cmd_bench_scaling(args):
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
    from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
    from genomeassembler_dev_tpu_torch.parallel import multihost
    from genomeassembler_dev_tpu_torch.parallel.scaling import measure_scaling
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_genome

    dev = _device(args)
    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as tmp:
        own_group = not dist.is_initialized()
        if own_group:
            if "RANK" in os.environ:  # started by torchrun
                multihost.initialize(device_type=dev.type)
            else:
                multihost.initialize(f"file://{os.path.join(tmp, 'store')}", 1, 0,
                                     device_type=dev.type)
        try:
            if dev.type == "cuda":
                dev = torch.device("cuda", torch.cuda.current_device())
            world = dist.get_world_size()
            counts = ([int(x) for x in args.devices.split(",")] if args.devices
                      else [1 << i for i in range(world.bit_length()) if 1 << i <= world])
            B = max(counts) * args.segments_per_device
            genomes = np.stack([encode_dna(synthetic_genome(i, args.seq_len))
                                for i in range(B)])
            pts = measure_scaling(genomes, load_default_query_table("cpu").probs[8].numpy(),
                                  args.read_len, args.draws_per_segment, counts, dev)
            if dist.get_rank() == 0:
                print(json.dumps([
                    {"devices": p.n_devices, "reads_per_s": round(p.reads_per_s, 1),
                     "efficiency": round(p.efficiency, 3)} for p in pts]))
        finally:
            if own_group:
                dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="genomeassembler_dev_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run one experiment")
    _add_common(p)
    p.add_argument("--ind", type=int, default=1, help="experiment index (1-based)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("study-own", help="own-dBG study grid (scripts/02)")
    _add_common(p)
    _add_study(p)
    p.set_defaults(fn=cmd_study_own)

    p = sub.add_parser("study-all",
                       help="full study chain 02 -> 01 -> 03 (scripts/submit.sh)")
    _add_common(p)
    _add_study(p)
    p.set_defaults(fn=cmd_study_all)

    p = sub.add_parser("study-velvet",
                       help="industry-standard study (scripts/00); external "
                            "contigs or velvet binaries")
    _add_common(p)
    p.add_argument("--grid", default=None,
                   help="comma list of read_len:dbg_kmer pairs, e.g. 12:11,40:37")
    p.add_argument("--contigs-dir", default=None,
                   help="directory of contigs_exp_<i>.fa files")
    p.set_defaults(fn=cmd_study_velvet)

    p = sub.add_parser("study-kmer-count", help="k-mer count vs prob (scripts/01)")
    _add_common(p)
    p.set_defaults(fn=cmd_study_kmer_count)

    p = sub.add_parser("study-gc", help="GC dependency (scripts/03)")
    _add_common(p)
    p.set_defaults(fn=cmd_study_gc)

    p = sub.add_parser("study-plots",
                       help="render the aggregated figure families from a "
                            "study's results_summary/results_all CSVs "
                            "(scripts/02_…:129-546, 00_…:129-169)")
    p.add_argument("study_dirs", nargs="+",
                   help="IndustryModel_* dirs holding the study CSVs")
    p.add_argument("--top-frac", type=float, default=0.05)
    p.set_defaults(fn=cmd_study_plots)

    p = sub.add_parser("fit-model", help="distil the QueryTable into the MLP")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    p.add_argument("--kmer", type=int, default=8)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="./breakage_model.npz")
    p.set_defaults(fn=cmd_fit_model)

    p = sub.add_parser("bench-scaling", help="throughput vs device count")
    p.add_argument("--device", default="cuda",
                   help="torch device type of the ranks (cuda, cpu)")
    p.add_argument("--devices", default=None,
                   help="comma list of device counts (default: 1, 2, 4, ... up to the "
                        "world size)")
    p.add_argument("--segments-per-device", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=500)
    p.add_argument("--read-len", type=int, default=12)
    p.add_argument("--draws-per-segment", type=int, default=256)
    p.set_defaults(fn=cmd_bench_scaling)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
