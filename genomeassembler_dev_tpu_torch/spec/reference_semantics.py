"""String-level spec of the reference's ordering-ensemble merge (the merge
part of genomeassembler_dev_tpu/spec/reference_semantics.py).

Clarity over speed: it backs `merge_backend="spec"` and the device merge's
exact collision guard (merge/device.py), and tests hold the native and device
merges against it.
"""

from __future__ import annotations

from genomeassembler_dev_tpu_torch.core.rng import MT19937, std_shuffle


def shuffled_orderings(contigs: list[str], seed: int, n_orderings: int) -> list[list[str]]:
    """The reference's shuffled contig matrix (cpp:194-205): n_orderings
    std::shuffle'd copies of the canonical contig list, engine state carried
    across orderings. Own path uses 10,000, velvet path 20,000
    (lib/BreakageScorer.cpp:85-94)."""
    eng = MT19937(seed)
    out = []
    for _ in range(n_orderings):
        cp = list(contigs)
        std_shuffle(cp, eng)
        out.append(cp)
    return out


def merge_one_ordering(contigs: list[str], dbg_kmer: int) -> list[str]:
    """One ordering's greedy merge fixpoint (cpp:228-266), bit-exact:

    for k = dbg_kmer-1 .. 1:
      repeat until the contig count stops changing:
        for i ascending (skipping emptied slots):
          for j descending over the whole list:
            if str(i) != str(j) and suffix_k(i) == prefix_k(j):
              contig[i] += contig[j][k:]; contig[j] = ""
        drop emptied slots

    Note contigs[i] is re-read after every merge (its suffix changes mid-scan)
    and the i != j case with *equal strings* is skipped, both as in the C++.
    """
    contigs = list(contigs)
    for k in range(dbg_kmer - 1, 0, -1):
        changed = True
        while changed:
            before = len(contigs)
            for i in range(len(contigs)):
                if contigs[i] == "":
                    continue
                for j in range(len(contigs) - 1, -1, -1):
                    ci = contigs[i]
                    cj = contigs[j]
                    # contigs shorter than the overlap are skipped: the
                    # reference's substr would throw out_of_range there
                    # (own-path contigs are always >= dbg_kmer, so this
                    # only affects short *external* contigs); all backends
                    # share this robustness contract
                    if (ci != cj and cj != "" and len(ci) >= k and len(cj) >= k
                            and ci[-k:] == cj[:k]):
                        contigs[i] = ci + cj[k:]
                        contigs[j] = ""
            contigs = [c for c in contigs if c != ""]
            changed = before != len(contigs)
    return contigs


def assemble_solutions(contig_matrix: list[list[str]], dbg_kmer: int) -> list[str]:
    """Merge every ordering, flatten, dedup, and sort by length descending
    (cpp:214-305). The reference's final std::sort is unstable, so the order
    of equal-length solutions is unspecified there; ties are ordered
    lexicographically. The solution *set* is bit-identical."""
    flat = set()
    for contigs in contig_matrix:
        flat.update(merge_one_ordering(contigs, dbg_kmer))
    return sorted(flat, key=lambda s: (-len(s), s))
