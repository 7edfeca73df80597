"""On the card: a short run of each cell is correct, and the control at the
cell's own size on three seeds is not."""

import json
import subprocess
import sys

import pytest

from portbench import control, harness

from .conftest import REPO

CELLS = [w["name"] for w in harness.manifest(REPO)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cuda_device, cell):
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                        "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(cuda_device, cell, in_repo):
    for seed in (11, 12, 13):
        assert not control.control_numbers(cell, seed, cuda_device, per_row=2)["correct"]
