"""The port's device trace (utils/profiling.py), on the CPU: `trace` writes a
Chrome-format trace file of the region, and `annotate` spans appear in it by
name, nested as they ran. On the card the same file holds each kernel's
events; chip_smoke.py [15] checks those."""

import glob
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from genomeassembler_dev_tpu_torch.ops.edit_distance import batched_levenshtein  # noqa: E402
from genomeassembler_dev_tpu_torch.ops.histogram import count_kmers_batched  # noqa: E402
from genomeassembler_dev_tpu_torch.ops.myers import batched_levenshtein_myers  # noqa: E402
from genomeassembler_dev_tpu_torch.utils.profiling import annotate, trace  # noqa: E402


def inputs():
    rng = np.random.default_rng(5)
    lev = (torch.from_numpy(rng.integers(0, 4, (8, 64)).astype(np.uint8)),
           torch.from_numpy(rng.integers(0, 65, 8).astype(np.int32)),
           torch.from_numpy(rng.integers(0, 4, 80).astype(np.uint8)))
    hist = (torch.from_numpy(rng.integers(0, 256, (2, 500)).astype(np.int32)),
            torch.from_numpy(rng.random((2, 500)) < 0.9))
    return lev, hist


def spans(path: str) -> dict:
    """{name: (start, end)} of the trace file's annotation events (us)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"}


def test_trace_writes_nested_annotations(tmp_path):
    (q, ql, t), (codes, valid) = inputs()
    with trace(str(tmp_path)) as prof:
        with annotate("region"):
            with annotate("levenshtein"):
                d = batched_levenshtein(q, ql, t)
            with annotate("histogram"):
                h = count_kmers_batched(codes, valid, 256)
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    got = spans(path)
    assert {"region", "levenshtein", "histogram"} <= got.keys()
    lo, hi = got["region"]
    for name in ("levenshtein", "histogram"):
        assert lo <= got[name][0] <= got[name][1] <= hi, name
    assert got["levenshtein"][1] <= got["histogram"][0]
    # the traced calls compute what they compute untraced
    assert torch.equal(d, batched_levenshtein(q, ql, t))
    assert torch.equal(h, count_kmers_batched(codes, valid, 256))
    names = {e.key for e in prof.key_averages()}
    assert {"region", "levenshtein", "histogram"} <= names


def test_annotate_outside_a_trace_and_cpu_only_activity(tmp_path):
    (q, ql, t), _ = inputs()
    with annotate("untraced"):
        want = batched_levenshtein_myers(q, ql, t)
    with trace(str(tmp_path / "a")):
        with annotate("myers wrapper on the CPU"):
            got = batched_levenshtein_myers(q, ql, t)
    assert torch.equal(got, want)
    (path,) = glob.glob(str(tmp_path / "a" / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert "myers wrapper on the CPU" in spans(path)
    if not torch.cuda.is_available():  # CPU tensors launch nothing on a card
        assert not [e for e in events if e.get("cat") == "kernel"]
