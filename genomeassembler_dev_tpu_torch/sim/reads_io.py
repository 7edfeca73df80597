"""Read-set artifacts: the reference's FASTA contract plus a fast npz format
(mirrors genomeassembler_dev_tpu/sim/reads_io.py; host numpy arrays in, the
same files out).

The reference writes, per experiment (lib/GenerateReads.R:387-479):

  data/reads/exp_<ind>/read_1<param>.fasta   forward reads, names
      '<chrom>_<abs_start>_<abs_end>:0_<i>/1'
  data/reads/exp_<ind>/read_2<param>.fasta   reverse complements, .../2
  data/reads/exp_<ind>/ref<param>.fasta      the segment, name 'seq-1'

with <param> = _SeqLen-..._SeqSeed-..._ReadLen-..._DBGKmer-... . These feed
external assemblers (velvet) and make runs replayable. The npz format stores
the packed code arrays directly — the framework's native replay format and
the gate for cross-backend bit-equality ("given identical read sets",
SURVEY.md §7.1).
"""

from __future__ import annotations

import os

import numpy as np

from genomeassembler_dev_tpu_torch.core.encoding import decode_dna, reverse_complement
from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
from genomeassembler_dev_tpu_torch.sim.segments import write_fasta


def read_param_string(cfg: ExperimentConfig) -> str:
    return (
        f"_SeqLen-{cfg.seq_len}_SeqSeed-{cfg.seed}"
        f"_ReadLen-{cfg.read_len}_DBGKmer-{cfg.dbg_kmer}"
    )


def reads_dir(workdir: str, ind: int) -> str:
    return os.path.join(workdir, "reads", f"exp_{ind}")


def save_read_fastas(
    workdir: str,
    ind: int,
    cfg: ExperimentConfig,
    read_codes: np.ndarray,
    read_valid: np.ndarray,
    positions: np.ndarray,
    segment: str,
    segment_name: str = "chrS_1",
) -> tuple[str, str, str]:
    """Write read_1/read_2/ref FASTAs with the reference's naming."""
    d = reads_dir(workdir, ind)
    os.makedirs(d, exist_ok=True)
    p = read_param_string(cfg)

    chrom, _, start = segment_name.rpartition("_")
    abs_start = int(start) if start.isdigit() else 0
    chrom = chrom or segment_name

    fwd, rev = {}, {}
    i = 0
    for codes, ok, pos in zip(read_codes, read_valid, positions):
        if not ok:
            continue
        i += 1
        # the reference's name uses 1-based absolute coordinates
        name = f"{chrom}_{abs_start + int(pos) + 1}_{abs_start + int(pos) + 1 + cfg.read_len}"
        fwd[f"{name}:0_{i}/1"] = decode_dna(codes)
        rev[f"{name}:0_{i}/2"] = decode_dna(reverse_complement(codes))

    p1 = os.path.join(d, f"read_1{p}.fasta")
    p2 = os.path.join(d, f"read_2{p}.fasta")
    pr = os.path.join(d, f"ref{p}.fasta")
    write_fasta(p1, fwd)
    write_fasta(p2, rev)
    write_fasta(pr, {"seq-1": segment})
    return p1, p2, pr


def save_read_set_npz(path: str, read_codes: np.ndarray, read_valid: np.ndarray,
                      positions: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, codes=read_codes, valid=read_valid,
                        positions=positions)


def load_read_set_npz(path: str):
    with np.load(path) as d:
        return d["codes"], d["valid"], d["positions"]
