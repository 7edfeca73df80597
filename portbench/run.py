"""Run one cell of the benchmark on one NVIDIA card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (correct, attempted, failed, metrics, device, with --trace 1
breakdown, and last the check's numbers with their limits); the check's
numbers are also the last lines of standard error. Exits non-zero with no
result where no card is present, where the cell asks for more cards than
there are, or where a forbidden module (jax, jaxlib, flax, the JAX package)
is loaded.

Build caches stay inside the checkout: the program builds its kernels into
build/torch_kernels/ and its native engine into native/, so only a
checkout's first run compiles.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308  # an undefined relative gap: the reference reads 0, the program not
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import harness

    bench = harness.manifest(".")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        import genomeassembler_dev_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 1
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), ".", t_start=t0)
    found = harness.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
