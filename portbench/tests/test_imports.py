"""No module that a run loads is jax, jaxlib, flax or the JAX package, by
top-level name compared whole; the reference loads nothing of the program."""

import subprocess
import sys

from .conftest import REPO

RUN_IMPORTS = """
import sys
import portbench.run, portbench.harness, portbench.control, portbench.trace
import genomeassembler_dev_tpu_torch.pipeline.experiments
import genomeassembler_dev_tpu_torch.pipeline.assembler
import genomeassembler_dev_tpu_torch.pipeline.results
from portbench import harness
found = harness.forbidden_loaded()
assert not found, found
assert "genomeassembler_dev_tpu_torch" in sys.modules
print("ok")
"""

REFERENCE_IMPORTS = """
import sys
import portbench.reference.experiment, portbench.reference.rng, portbench.traffic.segments
bad = sorted(n for n in sys.modules if n.split(".")[0].startswith("genomeassembler"))
assert not bad, bad
print("ok")
"""


def _run(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_a_run_loads_no_jax():
    r = _run(RUN_IMPORTS)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_the_reference_loads_nothing_of_the_program():
    r = _run(REFERENCE_IMPORTS)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_the_guard_compares_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", sys)
    monkeypatch.setitem(sys.modules, "genomeassembler_dev_tpu_torch_x", sys)
    assert "jaxlib_lookalike" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "genomeassembler_dev_tpu.core", sys)
    assert "genomeassembler_dev_tpu.core" in harness.forbidden_loaded()


def test_no_card_means_no_result(in_repo):
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "own1k.k9",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=in_repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
