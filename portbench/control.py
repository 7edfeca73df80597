"""The check's control: the plain reference put in the program's place and
computed in the nearest precisions below the configuration's (TF32 score
dots, bfloat16 KS inputs), judged by the same comparison as a run. It
must come out as not correct; its smallest score_rel_gap over seeds is the
upper reading that the limit is set below.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

runs on the run's device at the cell's own sizes: for each seed, as many
segments of the cell's set as a run's check takes, drawn from the seed and
shared evenly over the rows. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench.reference import experiment as reference
from portbench.traffic import segments as traffic


def control_numbers(cell: str, seed: int, device, per_row: int | None = None) -> dict:
    wl = harness.workload_file(cell)
    config = harness.config_file(wl["config"])
    mix = wl["traffic"]
    probs = reference.load_probs(reference.default_table_path())
    n = per_row or -(-mix["check_experiments"] // len(mix["rows"]))
    numbers = dict.fromkeys(harness.EXACT_CHECKS, 0) | {"score_rel_gap": float("inf")}
    gaps = []
    segs = traffic.segments(mix["set_seed"], 0, mix["set_size"],
                            config["experiment"]["seq_len"], mix["repeats"])
    rng = np.random.default_rng([seed, 3])
    for row in mix["rows"]:
        cfg = config["experiment"] | {"read_len": row[0], "dbg_kmer": row[1]}
        for i in rng.choice(len(segs), min(n, len(segs)), replace=False):
            seg = segs[i]
            ref = reference.run(seg, cfg, probs, device)
            ctl = reference.run(seg, cfg, probs, device, precision="control")
            out = harness.compare_rows(ctl["rows"], ctl["stats"], ref)
            for k in harness.EXACT_CHECKS:
                numbers[k] += out[k]
            gaps.append(out["score_rel_gap"])
    numbers["score_rel_gap"] = max(gaps)
    limits = harness.limits(config)
    numbers["correct"] = all(numbers[k] <= limits[k] for k in limits)
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_numbers(args.workload, seed, device)
        out |= {"workload": args.workload, "seed": seed, "device": str(device),
                "seconds": time.perf_counter() - t}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
