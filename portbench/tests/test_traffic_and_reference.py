"""The frozen generators equal the program's today; the plain reference
agrees with the program at tiny sizes on the CPU; the control does not."""

import numpy as np
import pytest
import torch

from portbench import control, harness
from portbench.reference import experiment as reference
from portbench.reference import rng as ref_rng
from portbench.traffic import segments as traffic

SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_frozen_generators_equal_the_programs(seed):
    from genomeassembler_dev_tpu_torch.sim import segments as program

    assert traffic.synthetic_genome([seed, 3], 1000) == program.synthetic_genome([seed, 3], 1000)
    seg = traffic.synthetic_genome([seed, 4], 1000)
    assert (traffic.plant_repeats(seg, np.random.default_rng([seed, 4, 1]))
            == program.plant_repeats(seg, np.random.default_rng([seed, 4, 1])))
    assert traffic.segment(seed, 2, 500, True) == traffic.segment(seed, 2, 500, True)
    assert traffic.segment(seed, 2, 500, False) != traffic.segment(seed, 3, 500, False)


def test_orderings_equal_the_programs():
    from genomeassembler_dev_tpu_torch.core import rng as program

    for n in (1, 2, 5, 12):
        assert np.array_equal(ref_rng.shuffle_orderings(n, 300, 1234),
                              program.shuffle_orderings(n, 300, 1234))


def test_reference_merge_equals_the_spec():
    from genomeassembler_dev_tpu_torch.spec import reference_semantics as spec

    contigs = sorted({traffic.synthetic_genome([1, i], 12)[: 9 + i % 4] for i in range(8)}
                     | {"ACGTACGTA", "CGTACGTAC", "GTACGTACG"})
    want = spec.assemble_solutions(spec.shuffled_orderings(contigs, 1234, 200), 9)
    assert reference.merge_solutions(contigs, 9, 1234, 200) == want


def test_banded_levenshtein_equals_the_row_dp():
    rng = np.random.default_rng(3)
    target = traffic.synthetic_genome([9, 9], 300)
    queries = [target[5:], target[:200] + target[210:], "ACGT" * 40,
               target.replace("A", "C", 7)]
    for q in queries + [traffic.synthetic_genome([9, int(rng.integers(100))], 290)]:
        assert reference._levenshtein_banded(q, target) == reference._levenshtein_rows(
            [q], target, "cpu")[0]


def test_a_run_cycles_through_the_set_in_its_order():
    segs = traffic.segments(1234, 0, 3, 50, False)
    assert traffic.cycle(segs, 2, 5) == [segs[2], segs[0], segs[1], segs[2], segs[0]]


def _study_run(n_calls=4, per_call=200, seg_batch=64, check=16):
    calls, exps = [], []
    for c in range(n_calls):
        row = [(12, 9), (14, 9)][c % 2]
        ce = [harness.Experiment(f"call{c}", i + 1, row, f"s{i}") for i in range(per_call)]
        heads = list(range(1, per_call + 1, seg_batch))
        calls.append(harness.Call(row, 1.0, f"call{c}", ce, heads, {}))
        exps += ce
    return harness.Run("own1k.k9", {"seg_batch": seg_batch}, {"check_experiments": check},
                       1.0, 1.0, exps, calls)


def test_the_check_sample_takes_batch_edges_and_every_row():
    run = _study_run()
    assert harness.batch_edges(run.calls[0]) == {1, 64, 65, 128, 129, 192, 193, 200}
    sample = harness.check_sample(run, 2**31 + 5)
    assert len(sample) == 16 == len({id(e) for e in sample})
    for row in ((12, 9), (14, 9)):
        mine = [e for e in sample if e.row == row]
        assert len(mine) == 8
        assert sum(e.ind in {1, 64, 65, 128, 129, 192, 193, 200} for e in mine) == 4
    assert [id(e) for e in harness.check_sample(run, 2**31 + 5)] == [id(e) for e in sample]
    assert [id(e) for e in harness.check_sample(run, 7)] != [id(e) for e in sample]


TINY = {"config": {"seg_batch": 2},
        "traffic": {"total_iters": 3, "set_seed": 1234, "set_size": 3, "check_experiments": 2}}
TINY_SERIAL = {"config": {"experiment": {
    "seq_len": 2000, "read_len": 150, "dbg_kmer": 31, "coverage_target": 40.0, "kmer": 8,
    "seed": 1234, "n_orderings": 10000, "merge_backend": "auto"}},
    "traffic": {"set_seed": 1234, "set_size": 2, "check_experiments": 1}}


@pytest.mark.parametrize("cell,overrides", [
    ("own1k.k9", TINY),
    ("own1k.k9", {"config": TINY["config"],
                  "traffic": TINY["traffic"] | {"rows": [[16, 13]], "repeats": True}}),
    ("own1k.k9", {"config": TINY["config"], "traffic": TINY["traffic"] | {"rows": [[40, 15]]}}),
    ("own50k.config1", TINY_SERIAL)], ids=["k9", "repeats_16_13", "k15_40_15", "serial_2kb"])
def test_reference_agrees_with_the_program(in_repo, cell, overrides):
    res = harness.run_cell(cell, 2**31 + 99, 0.01, False, torch.device("cpu"), in_repo,
                           log=lambda m: None, overrides=overrides)
    checks = res["checks"]
    assert res["correct"], checks
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert 0 < checks["score_rel_gap"]["value"] < checks["score_rel_gap"]["limit"] / 5
    assert set(res["metrics"]) == set(harness.cell_metrics(harness.manifest(in_repo), cell,
                                                           "end_to_end"))


@pytest.mark.parametrize("cell", ["own1k.k9", "own50k.config1"])
def test_the_control_is_not_correct(in_repo, cell):
    out = control.control_numbers(cell, 5, torch.device("cpu"), per_row=1)
    assert not out["correct"]
    limit = harness.limits(harness.config_file(harness.workload_file(cell)["config"]))
    assert out["score_rel_gap"] > limit["score_rel_gap"]
