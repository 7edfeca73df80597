"""Benchmark of the PyTorch and CUDA port (genomeassembler_dev_tpu_torch) on
one NVIDIA H100: `python -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout."""
