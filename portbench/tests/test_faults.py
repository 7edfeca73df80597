"""A run of each entry, past the harness's look for a card, with the timed
path broken underneath: `correct` has to come out false. The faults these
cells can have: an answer altered where it is produced, and half of the
batch left out with the mean taken over the rest. (A step that returns its
state unchanged is a training fault, and an exchange between chips does not
exist on these one-chip cells.)"""

import pytest
import torch

from portbench import harness

from .test_traffic_and_reference import TINY, TINY_SERIAL

ENTRIES = {"own1k.k9": ("batch_runner", TINY), "own50k.config1": ("assembler", TINY_SERIAL)}


def altered_answer(fn):
    def wrapped(queries, lens, target, mode="NW"):
        out = fn(queries, lens, target, mode=mode).clone()
        out[0] += 1  # one solution's distance, where the kernel produces it
        return out
    return wrapped


def half_the_reads(fn):
    def wrapped(pm, pl, rc, rn, rv, probs, break_kmer=8):
        rv = rv.clone()
        rv[..., 1::2] = False  # half of the batch's reads left out
        return fn(pm, pl, rc, rn, rv, probs, break_kmer=break_kmer)
    return wrapped


@pytest.mark.parametrize("cell", sorted(ENTRIES))
@pytest.mark.parametrize("fault,target,wrap", [
    ("altered_answer", "batched_levenshtein_auto", altered_answer),
    ("half_the_batch", "breakscore", half_the_reads)])
def test_a_broken_program_is_not_correct(in_repo, monkeypatch, cell, fault, target, wrap):
    import importlib

    module_name, overrides = ENTRIES[cell]
    mod = importlib.import_module(f"genomeassembler_dev_tpu_torch.pipeline.{module_name}")
    monkeypatch.setattr(mod, target, wrap(getattr(mod, target)))
    res = harness.run_cell(cell, 2**32 + 1, 0.01, False, torch.device("cpu"), in_repo,
                           log=lambda m: None, overrides=overrides)
    assert not res["correct"], (fault, res["checks"])
    assert res["checks"]["int_columns"]["value"] > 0
