"""Sharded pipeline steps (mirrors genomeassembler_dev_tpu/parallel/sharding.py),
on torch.distributed.

  * simulate+count (seg x read): each (segment, read-shard) rank simulates
    its slice of the breakpoint draws and counts k-mers locally with the
    histogram kernel (ops/histogram.py); partial histograms are summed over
    `read`.
  * breakscore (seg x read x tp): reads sharded over `read` (partial break
    counts summed), the probability table row-sharded over `tp` (partial
    dots summed).
  * KS and Levenshtein: `seg` data parallelism; Levenshtein goes through
    the Myers kernel on CUDA.
  * MLP train step (dp x tp): the batch over (seg, read) as dp, the hidden
    dimension over tp (w1, b1 column-sharded, w2 row-sharded).

Every rank calls a step with the same global inputs and gets back its own
block of the output (its `seg` block, replicated over `read` and `tp`);
parallel.mesh.gather assembles the global result. The steps take any mesh
whose axes are a subset of (seg, read, tp): a missing axis has size 1.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from genomeassembler_dev_tpu_torch.core.querytable import TOTAL
from genomeassembler_dev_tpu_torch.models import breakage_model as bm
from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein_auto
from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers_batched
from genomeassembler_dev_tpu_torch.ops.ks import batched_ks_2samp, ks_2samp_sparse
from genomeassembler_dev_tpu_torch.ops.windows import kmer_window_codes
from genomeassembler_dev_tpu_torch.parallel.mesh import (
    all_reduce, axis_group, axis_index, axis_size, block, gather)
from genomeassembler_dev_tpu_torch.score.breakscore import breakscore, dot_f32
from genomeassembler_dev_tpu_torch.sim.reads import (
    ReadSet, probability_track, reads_from_uniforms)


def shard_seed(seed: int, read_idx: int) -> int:
    """The generator seed of one segment's read shard (JAX: fold_in)."""
    return (int(seed) << 16) | read_idx


def simulate_read_shard(genomes: torch.Tensor, seeds: torch.Tensor, probs_k8: torch.Tensor,
                        read_len: int, n_draws: int, read_idx: int,
                        break_kmer: int = 8) -> ReadSet:
    """The reads that read shard `read_idx` draws for each segment of
    genomes [B, L]: n_draws uniforms a segment from a generator seeded with
    shard_seed(seeds[b], read_idx), then inverse-CDF breakpoints."""
    dev = genomes.device
    u = torch.empty((genomes.shape[0], n_draws), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    for b, seed in enumerate(seeds.tolist()):
        gen.manual_seed(shard_seed(seed, read_idx))
        u[b] = torch.rand(n_draws, generator=gen, dtype=torch.float32, device=dev)
    track = probability_track(genomes, probs_k8, break_kmer)
    return reads_from_uniforms(u, genomes, track, read_len)


def make_sim_count_step(mesh: DeviceMesh, read_len: int, n_draws: int, count_k: int,
                        break_kmer: int = 8):
    """Returns step(genomes [B, L], seeds [B], probs_k8 [65536]) -> this
    rank's seg block of counts [B/seg, 4^count_k] int32, summed over `read`.

    B must divide by the seg axis; n_draws splits over the read axis."""
    n_read = axis_size(mesh, "read")
    if n_draws % n_read:
        raise ValueError(f"n_draws={n_draws} not divisible by read axis {n_read}")
    draws_local = n_draws // n_read

    def step(genomes, seeds, probs_k8):
        blk = block(genomes.shape[0], mesh, "seg")
        rs = simulate_read_shard(genomes[blk], seeds[blk], probs_k8, read_len, draws_local,
                                 axis_index(mesh, "read"), break_kmer)
        codes, valid = kmer_window_codes(rs.codes, count_k)  # [Bl, draws, windows]
        valid = valid & rs.valid[..., None]
        Bl = codes.shape[0]
        counts = count_kmers_batched(codes.reshape(Bl, -1), valid.reshape(Bl, -1), 4**count_k)
        return all_reduce(counts, mesh, "read")

    return step


def make_breakscore_step(mesh: DeviceMesh, break_kmer: int = 8):
    """Returns step(paths [B,S,L], plens [B,S], rcodes [B,U,R], rcounts [B,U],
    rvalid [B,U], probs [TOTAL]) -> this rank's seg block of the full
    per-solution output set: a dict with bp_score,
    bp_score_norm_by_break_freqs, bp_score_norm_by_len [Bl,S] float32,
    kmer_breaks [Bl,S] int32, path_freq and site_counts [Bl,S,TOTAL] float32
    (path_freq NaN where a solution has no break).

    Reads sharded over `read` (partial break counts summed), table rows
    sharded over `tp` (partial dots summed). U must divide by the read axis
    and TOTAL by the tp axis."""

    def step(paths, plens, rcodes, rcounts, rvalid, probs):
        seg = block(paths.shape[0], mesh, "seg")
        rd = block(rcodes.shape[1], mesh, "read")
        pl = plens[seg]
        zeros = torch.zeros(TOTAL, dtype=torch.float32, device=paths.device)
        counts = breakscore(paths[seg], pl, rcodes[seg, rd], rcounts[seg, rd], rvalid[seg, rd],
                            zeros, break_kmer=break_kmer).site_counts  # [Bl, S, TOTAL]
        counts = all_reduce(counts, mesh, "read")
        total = counts.sum(dim=2)  # [Bl, S] == kmer_breaks
        safe_total = total.clamp(min=1.0)[..., None]

        tpb = block(TOTAL, mesh, "tp")
        local = counts[..., tpb]
        p = probs.to(torch.float32)[tpb]
        bp_score = all_reduce(dot_f32(local, p), mesh, "tp")
        norm_by_breaks = all_reduce(dot_f32(local / safe_total, p), mesh, "tp")
        return {
            "bp_score": bp_score,
            "bp_score_norm_by_break_freqs": torch.where(total > 0, norm_by_breaks, 0.0),
            "bp_score_norm_by_len": bp_score / pl.to(torch.float32).clamp(min=1.0),
            "kmer_breaks": total.to(torch.int32),
            "path_freq": torch.where(total[..., None] > 0, counts / safe_total, float("nan")),
            "site_counts": counts,
        }

    return step


def make_ks_step(mesh: DeviceMesh):
    """Sharded per-solution KS statistic: step(path_freq [B,S,T], tracks
    [B,W], nonzero_bound) -> this rank's [B/seg, S] float32; only `seg`
    parallelism applies (the KS is per solution). nonzero_bound is the most
    entries of a row that are not 0.0: the breakscore step's padded read
    count, or None for any. CUDA rows are one K4 launch for the rank's
    block (ops/ks.py::ks_2samp_sparse), CPU rows the pooled sort a segment."""

    def step(path_freq, tracks, nonzero_bound=None):
        blk = block(path_freq.shape[0], mesh, "seg")
        pf, tr = path_freq[blk], tracks[blk]
        if pf.device.type == "cuda":
            bound = pf.shape[2] if nonzero_bound is None else nonzero_bound
            return ks_2samp_sparse(pf.reshape(-1, pf.shape[2]), tr.contiguous(),
                                   bound).view(pf.shape[:2])
        return torch.stack([batched_ks_2samp(f, t) for f, t in zip(pf, tr)])

    return step


def make_lev_step(mesh: DeviceMesh, mode: str = "NW"):
    """Sharded Levenshtein vs each segment's truth: step(pm [B,S,L], pl
    [B,S], gm [B,L]) -> this rank's [B/seg, S] int32, one Myers kernel call
    a segment on CUDA."""

    def step(pm, pl, gm):
        blk = block(pm.shape[0], mesh, "seg")
        return torch.stack([batched_levenshtein_auto(a, b, g, mode=mode)
                            for a, b, g in zip(pm[blk], pl[blk], gm[blk])])

    return step


class _ReduceFromTP(torch.autograd.Function):
    """Sum of the tp ranks' partial outputs in forward, identity in backward
    (each rank's partial output gets the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        if group is not None:
            dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    """Identity in forward, sum of the tp ranks' gradients in backward: the
    input of a column-sharded layer, which every tp rank reads whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        if ctx.group is not None:
            dist.all_reduce(g, group=ctx.group)
        return g, None


# parameter name -> the dimension sharded over tp (None: replicated)
TP_DIMS = {"w1": 1, "b1": 0, "w2": 0, "b2": None, "w3": None, "b3": None}


def shard_params(mesh: DeviceMesh, params: bm.BreakageMLP) -> bm.BreakageMLP:
    """This rank's tp shard of the full model: w1 [d_in, H/tp], b1 [H/tp],
    w2 [H/tp, H], the rest replicated (JAX: the param_shardings)."""
    arrays = {}
    for name, dim in TP_DIMS.items():
        p = getattr(params, name).detach()
        if dim is not None:
            p = p.narrow(dim, block(p.shape[dim], mesh, "tp").start,
                         p.shape[dim] // axis_size(mesh, "tp"))
        arrays[name] = p.cpu().numpy()
    return bm.params_from_numpy(arrays, params.w1.device)


def unshard_params(mesh: DeviceMesh, local: bm.BreakageMLP) -> bm.BreakageMLP:
    """The full model from each rank's tp shard (an all-gather over tp)."""
    arrays = {}
    for name, dim in TP_DIMS.items():
        p = getattr(local, name).detach()
        arrays[name] = (p if dim is None else gather(p, mesh, "tp", dim)).cpu().numpy()
    return bm.params_from_numpy(arrays, local.w1.device)


def sharded_forward(mesh: DeviceMesh, local: bm.BreakageMLP, feats: torch.Tensor) -> torch.Tensor:
    """BreakageMLP.forward on this rank's tp shard: layer 1 column-parallel,
    layer 2 row-parallel with its partial output summed over tp, layer 3
    replicated. The weights' gradients stay float32: the train step rounds
    them to bf16 after their sum over dp."""
    group = axis_group(mesh, "tp")
    x = _CopyToTP.apply(feats, group)
    h = torch.nn.functional.gelu(bm.bf16_dot(x, local.w1, False) + local.b1, approximate="tanh")
    h = _ReduceFromTP.apply(bm.bf16_dot(h, local.w2, False), group) + local.b2
    h = torch.nn.functional.gelu(h, approximate="tanh")
    return (bm.bf16_dot(h, local.w3, False) + local.b3)[:, 0]


def make_sharded_train_step(mesh: DeviceMesh, optimizer: torch.optim.Optimizer):
    """dp x tp sharded MLP train step. Returns train_step(local, codes,
    target_logp) -> the global loss, where `local` is this rank's
    shard_params(...) and `optimizer` holds its parameters; codes and
    target_logp are the global batch, which splits over (seg, read).

    Gradients are averaged over dp with all-reduces, and the weights'
    gradients rounded to bf16 after the reduction, as the unsharded JAX
    gradient is. Adam is elementwise, so each rank updates its own shard."""
    dp = ("seg", "read")
    n_dp = axis_size(mesh, "seg") * axis_size(mesh, "read")

    def train_step(local: bm.BreakageMLP, codes: torch.Tensor,
                   target_logp: torch.Tensor) -> torch.Tensor:
        n = codes.shape[0]
        if n % n_dp:
            raise ValueError(f"batch {n} not divisible by dp={n_dp}")
        per = n // n_dp
        i = axis_index(mesh, "seg") * axis_size(mesh, "read") + axis_index(mesh, "read")
        rows = slice(i * per, (i + 1) * per)
        optimizer.zero_grad(set_to_none=True)
        k = local.w1.shape[0] // 4
        pred = sharded_forward(mesh, local, bm.one_hot_octamer(codes[rows], k))
        loss = torch.mean((pred - target_logp[rows]) ** 2)
        loss.backward()
        for name in bm.PARAM_NAMES:
            g = all_reduce(getattr(local, name).grad, mesh, dp)
            g /= n_dp
            if name.startswith("w"):
                g.copy_(bm.round_bf16(g))
        optimizer.step()
        return all_reduce(loss.detach(), mesh, dp) / n_dp

    return train_step
