"""genomeassembler_dev_tpu_torch — the PyTorch/CUDA port of genomeassembler_dev_tpu.

The same pipeline (simulate ultrasonication-biased reads, assemble them with a
de Bruijn graph, merge shuffled contig orderings, score every solution) with
plain PyTorch tensor code on an explicit `device`, and the Myers bit-vector
Levenshtein as a CUDA kernel written for Hopper (`csrc/myers.cu`). Module
names and layout follow the JAX package so each module's counterpart is easy
to find. Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"
