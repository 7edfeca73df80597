"""Shuffled-ensemble greedy merge on a device (mirrors
genomeassembler_dev_tpu/merge/device.py).

The reference merges each of 10,000 shuffled contig orderings to fixpoint
with in-place string surgery (lib/DeNovoAssembler.cpp:214-305). The native
engine (merge/native.py) threads that loop over host cores; this module runs
the whole ensemble with the ordering dimension [O] as the vector axis: every
(k, i) step decides and applies the next merge for all orderings at once.

Representation per (ordering, slot), as in the JAX module:
  * alive, length;
  * pre16/suf16 — the first/last 16 bases packed (an absorb keeps the head's
    prefix and takes the absorbed chain's suffix), giving O(1)
    suffix_k == prefix_k tests as integer mask/shift compares;
  * two 32-bit polynomial rolling hashes of the full string — concatenation
    with a k-trimmed chain is h(A)*p^(lenB-k) + (h(B) - h(B[:k])*p^(lenB-k))
    in wrapping 32-bit arithmetic. They live in int64 tensors masked with
    0xFFFFFFFF after each step: a signed int64 product wraps modulo 2^64,
    which keeps its low 32 bits exact, and torch.uint32 lacks most
    arithmetic on CUDA. The reference's `contigs[i] != contigs[j]` guard
    becomes (len, h1, h2) equality; an ordering where that equality gated a
    merge decision is re-merged exactly on the host (`eqflag`), so the
    backend is exact;
  * chain links over slots (next/trim/tail), from which the merged strings
    are rebuilt on the host: no character buffers on the device.

Scan order replicates the reference: for k = K-1..1, repeat until no
ordering shrinks: i ascending, j descending, skipping dead slots. An i-pass
jumps from merge to merge (the next j the reference would merge is the
largest candidate below the current position under i's current state). The
JAX module's loops become host loops whose condition is one `.any()` or
`.sum()` read a pass, and its one-hot selections (a TPU workaround for
gathers) are gathers and scatters here.
"""

from __future__ import annotations

import numpy as np
import torch

from genomeassembler_dev_tpu_torch.core.encoding import encode_dna
from genomeassembler_dev_tpu_torch.core.rng import shuffle_orderings
from genomeassembler_dev_tpu_torch.spec.reference_semantics import merge_one_ordering

# pre16/suf16 hold a contig's first and last 16 bases, so the merge tests
# overlaps k <= dbg_kmer - 1 of at most 16 bases, as the JAX module does
MAX_DBG_KMER = 17
_P1 = np.uint32(1000003)
_P2 = np.uint32(805306457)
_M32 = 0xFFFFFFFF


def _hash_arrays(contigs: list[str]):
    """Per-contig: packed pre16/suf16, lengths, two rolling hashes, and the
    hashes of every prefix of the first 16 characters (for trim-k removal).
    Also power tables p^x for x up to the total length. Host numpy arrays,
    uint32 (int32 lengths), as the JAX module's."""
    C = len(contigs)
    pre16 = np.zeros(C, np.uint32)
    suf16 = np.zeros(C, np.uint32)
    lens = np.zeros(C, np.int32)
    h1 = np.zeros(C, np.uint32)
    h2 = np.zeros(C, np.uint32)
    hpre1 = np.zeros((C, 16), np.uint32)
    hpre2 = np.zeros((C, 16), np.uint32)
    for ci, s in enumerate(contigs):
        codes = encode_dna(s).astype(np.uint32)
        lens[ci] = len(s)
        a = 0
        b = 0
        for t, c in enumerate(codes):
            a = (a * int(_P1) + int(c)) & _M32
            b = (b * int(_P2) + int(c)) & _M32
            if t < 16:
                hpre1[ci, t] = a  # hash of s[:t+1]
                hpre2[ci, t] = b
        h1[ci] = a
        h2[ci] = b
        p = codes[:16]
        pre16[ci] = sum(int(c) << (2 * (15 - t)) for t, c in enumerate(p))
        sfx = codes[-16:] if len(codes) >= 16 else codes
        suf16[ci] = sum(int(c) << (2 * (len(sfx) - 1 - t)) for t, c in enumerate(sfx))
    # power tables up to the largest possible merged length
    total = int(lens.sum())
    pow1 = np.ones(total + 1, np.uint32)
    pow2 = np.ones(total + 1, np.uint32)
    a = b = 1
    for x in range(1, total + 1):
        a = (a * int(_P1)) & _M32
        b = (b * int(_P2)) & _M32
        pow1[x] = a
        pow2[x] = b
    return pre16, suf16, lens, h1, h2, hpre1, hpre2, pow1, pow2


def _merge_kernel(perms, pre16_c, suf16_c, lens_c, h1_c, h2_c, hpre1_c, hpre2_c,
                  pow1, pow2, dbg_kmer: int):
    """perms: [O, C] int64 contig index per slot; the per-contig arrays are
    int64 tensors on perms' device. Returns the final chain state (alive
    [O, C] bool, next [O, C] int64, trim [O, C] int64, eqflag [O] bool)."""
    O, C = perms.shape
    dev = perms.device
    alive = torch.ones((O, C), dtype=torch.bool, device=dev)
    eqflag = torch.zeros(O, dtype=torch.bool, device=dev)
    ln, pre16, suf16 = lens_c[perms], pre16_c[perms], suf16_c[perms]
    h1, h2 = h1_c[perms], h2_c[perms]
    nxt = torch.full((O, C), -1, dtype=torch.int64, device=dev)
    trim = torch.zeros((O, C), dtype=torch.int64, device=dev)
    tail = torch.arange(C, device=dev).expand(O, C).clone()
    j_iota = torch.arange(C, device=dev)

    def sel(A, js):
        return A.gather(1, js[:, None])[:, 0]

    def put(A, idx, hit, value):
        """A[o, idx[o]] = value[o] where hit[o]."""
        A.scatter_(1, idx[:, None], torch.where(hit, value, sel(A, idx))[:, None])

    for k in range(dbg_kmer - 1, 0, -1):
        # invariant in the k-phase: a slot's head contig never changes
        prefix_k = pre16 >> (2 * (16 - k))
        hk1, hk2 = hpre1_c[perms, k - 1], hpre2_c[perms, k - 1]
        mask_k = (1 << (2 * k)) - 1
        changed = True
        while changed:
            before = int(alive.sum())
            for i in range(C):
                # one i-pass: j descends from C-1 with i re-read after every
                # merge. The j columns hold their state from the start of the
                # pass (only column i changes, written back at its end); a j
                # killed in the pass lies above the position pointer, so the
                # live `alive` masks the same j as a snapshot would.
                active = alive[:, i].clone()
                if not bool(active.any()):
                    continue
                base = (j_iota[None, :] != i) & (ln >= k)
                pos = torch.full((O,), C - 1, dtype=torch.int64, device=dev)
                li, h1i, h2i, sufi, taili = ln[:, i], h1[:, i], h2[:, i], suf16[:, i], tail[:, i]
                while True:
                    str_eq = (li[:, None] == ln) & (h1i[:, None] == h1) & (h2i[:, None] == h2)
                    can_but_eq = ((active & (li >= k))[:, None]
                                  & (j_iota[None, :] <= pos[:, None]) & base & alive
                                  & ((sufi & mask_k)[:, None] == prefix_k))
                    can = can_but_eq & ~str_eq
                    # a (len, h1, h2)-equality that gated a merge decision:
                    # the reference's own != guard if the strings are equal,
                    # a wrong skip if the hashes collided, so the ordering is
                    # re-merged exactly on the host
                    eqflag |= (can_but_eq & str_eq).any(dim=1)
                    j_sel = torch.where(can, j_iota[None, :], -1).amax(dim=1)
                    hit = j_sel >= 0
                    if not bool(hit.any()):
                        break
                    js = j_sel.clamp(min=0)
                    tail_len = torch.where(hit, sel(ln, js) - k, 0)
                    p1, p2 = pow1[tail_len], pow2[tail_len]
                    h1n = (h1i * p1 + sel(h1, js) - sel(hk1, js) * p1) & _M32
                    h2n = (h2i * p2 + sel(h2, js) - sel(hk2, js) * p2) & _M32
                    # chain links: next[o, tail_i] = j, trim[o, j] = k; kill j
                    put(nxt, taili, hit, js)
                    put(trim, js, hit, torch.full_like(js, k))
                    put(alive, js, hit, torch.zeros_like(hit))
                    li = torch.where(hit, li + tail_len, li)
                    h1i = torch.where(hit, h1n, h1i)
                    h2i = torch.where(hit, h2n, h2i)
                    sufi = torch.where(hit, sel(suf16, js), sufi)
                    taili = torch.where(hit, sel(tail, js), taili)
                    pos = torch.where(hit, js - 1, pos)
                    active = hit
                ln[:, i], h1[:, i], h2[:, i], suf16[:, i], tail[:, i] = li, h1i, h2i, sufi, taili
            changed = int(alive.sum()) < before
    return alive, nxt, trim, eqflag


def assemble_device(contigs: list[str], dbg_kmer: int, seed: int, n_orderings: int,
                    device) -> list[str]:
    """The ensemble merge on `device`; the contract of
    merge.native.assemble_native: deduplicated solutions sorted by
    (-length, lexicographic). `assemble_device.last_n_fallback` is the number
    of orderings re-merged exactly on the host in the last call. Raises
    for dbg_kmer above MAX_DBG_KMER."""
    if dbg_kmer > MAX_DBG_KMER:
        raise ValueError(f"the device merge takes dbg_kmer <= {MAX_DBG_KMER} (overlaps of at "
                         f"most 16 bases), not {dbg_kmer}")
    assemble_device.last_n_fallback = 0
    if not contigs:
        return []
    if len(contigs) == 1:
        return list(contigs)
    dev = torch.device(device)
    perms = shuffle_orderings(len(contigs), n_orderings, seed)
    arrays = [torch.from_numpy(a.astype(np.int64)).to(dev) for a in _hash_arrays(contigs)]
    alive, nxt, trim, eqflag = (
        x.cpu().numpy()
        for x in _merge_kernel(torch.from_numpy(perms).long().to(dev), *arrays, dbg_kmer))

    out = set()
    n_fallback = 0
    for o in range(perms.shape[0]):
        if eqflag[o]:
            # the collision guard: this ordering's equality gates may have
            # been hash collisions, so it is merged exactly (string semantics)
            out.update(merge_one_ordering([contigs[p] for p in perms[o]], dbg_kmer))
            n_fallback += 1
            continue
        next_o, trim_o, perm_o = nxt[o], trim[o], perms[o]
        for s in np.nonzero(alive[o])[0]:
            parts = [contigs[perm_o[s]]]
            cur = next_o[s]
            while cur != -1:
                parts.append(contigs[perm_o[cur]][trim_o[cur]:])
                cur = next_o[cur]
            out.add("".join(parts))
    assemble_device.last_n_fallback = n_fallback
    return sorted(out, key=lambda s: (-len(s), s))


assemble_device.last_n_fallback = 0
