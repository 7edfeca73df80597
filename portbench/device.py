"""The card a run used, as nvidia-smi names it (a copy of
genomeassembler_dev_tpu_torch/bench.py::device_entry as of the benchmark's
first version)."""

from __future__ import annotations

import subprocess

import torch


def device_entry(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    index = device.index if device.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"platform": "gpu", "name": name, "power_limit": limit}
