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


# -- the program's own spans and counters ------------------------------------

import os  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from genomeassembler_dev_tpu_torch.utils import profiling  # noqa: E402

# every span and counter that a batched study and a serial experiment record
RUNNER_SPANS = {"study.batch", "study.save", "results.save", "study.aggregate", "runner.setup",
                "runner.n_reads", "runner.merge", "runner.merge_wait", "runner.pack",
                "runner.results", "Generating sequencing reads (batched)",
                "Running DBG de novo genome assembler (batched)",
                "Merging + evaluating solutions (overlapped)",
                "Evaluating each de novo assembled solution (grouped)"}
EVAL_SPANS = {"eval.pack", "eval.breakscore", "eval.random", "eval.ks", "eval.levenshtein",
              "eval.readback", "eval.columns"}
SERIAL_SPANS = {"Generating sequencing reads", "Running DBG de novo genome assembler",
                "Merging shuffled contig orderings",
                "Evaluating each de novo assembled solution"}
COUNTERS = {"merge.contigs", "merge.solutions", "merge.calls.native", "eval.bases",
            "eval.cells"}


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing():
    profiling.collect()
    assert not profiling.tracing()
    span = profiling.annotate("untraced")
    assert span is profiling.annotate("another")  # one shared null context
    with span:
        profiling.count("untraced.counter", 5)
    rec = profiling.collect()
    assert rec.spans == [] and rec.counters == {}


def test_nested_spans_carry_their_parent():
    profiling.collect()
    with recording():
        assert profiling.tracing()
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                profiling.count("n", 2)
                profiling.count("n")
            with profiling.annotate("second"):
                pass
    rec = profiling.collect()
    assert [s.name for s in rec.spans] == ["outer", "inner", "second"]
    outer, inner, second = rec.spans
    assert (outer.parent, inner.parent, second.parent) == (-1, 0, 0)
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= second.start_ns
    assert second.end_ns <= outer.end_ns
    assert rec.counters == {"n": 3}
    assert {s.thread for s in rec.spans} == {threading.get_ident()} == {rec.owner}
    assert profiling.collect().spans == []  # collect clears


def test_a_worker_thread_span_is_recorded_with_its_thread():
    profiling.collect()
    pool = ThreadPoolExecutor(max_workers=1)  # started before the session, as the runner's

    def work():
        with profiling.annotate("worker.span"):
            time.sleep(0.001)
        return threading.get_ident()

    pool.submit(int).result()
    try:
        with recording() as prof:
            with profiling.annotate("main.span"):
                worker = pool.submit(work).result()
    finally:
        pool.shutdown()
    rec = profiling.collect()
    by_name = {s.name: s for s in rec.spans}
    assert by_name["worker.span"].thread == worker != threading.get_ident()
    assert by_name["worker.span"].parent == -1  # no span was open on its thread
    assert by_name["main.span"].thread == rec.owner
    main = by_name["main.span"]
    assert main.start_ns <= by_name["worker.span"].start_ns <= main.end_ns
    # the profiler keeps only the owner's span; the worker's lives in the record
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "main.span" in names and "worker.span" not in names


def test_spans_are_on_the_clock_of_the_profilers_events():
    profiling.collect()
    with recording() as prof:
        with profiling.annotate("warm"):  # the first record_function of a session is slow
            pass
        for i in range(3):
            with profiling.annotate(f"clock{i}"):
                time.sleep(0.002)
    rec = profiling.collect()
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events()}
    starts = []
    for s in rec.spans[1:]:
        e = kineto[s.name]
        starts.append(abs(s.start_ns - e.start_ns()))
        # the span ends just before its record_function's exit, which stamps its own
        assert 0 <= e.start_ns() + e.duration_ns() - s.end_ns < 2_000_000, s.name
    # within 0.1 ms: the median, as a busy host may stall any single one
    assert sorted(starts)[1] < 100_000, starts


def _tables(workdir):
    """{relative path: bytes} of every CSV the study wrote."""
    out = {}
    for root, _, files in os.walk(workdir):
        for f in files:
            if f.endswith(".csv"):
                path = os.path.join(root, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, workdir)] = fh.read()
    return out


def test_a_traced_study_and_experiment_record_every_span_and_equal_untraced():
    from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
    from genomeassembler_dev_tpu_torch.pipeline.assembler import Assembler
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.pipeline.experiments import run_own_study
    from genomeassembler_dev_tpu_torch.pipeline.velvet import IndustryAssembler
    from genomeassembler_dev_tpu_torch.sim.segments import SegmentStore, synthetic_genome

    table = load_default_query_table("cpu")
    segs = tuple(synthetic_genome(i + 1, 300) for i in range(3))
    store = SegmentStore(names=tuple(f"s{i}" for i in range(3)), seqs=segs)
    base = ExperimentConfig(seq_len=300, coverage_target=12.0, kmer=8, seed=1234,
                            n_orderings=50)

    def study():
        wd = tempfile.mkdtemp()
        run_own_study(wd, store, "cpu", base, grid=((12, 9),), total_iters=3, table=table,
                      batched=True, seg_batch=2)
        return _tables(wd)

    asm = Assembler(base.with_(read_len=12, dbg_kmer=9), "cpu", table)
    # the velvet path on tiles of the segment that overlap by dbg k - 1
    vasm = IndustryAssembler(base.with_(read_len=12, dbg_kmer=11, industry_standard=True,
                                        velvet_n_orderings=50), "cpu", table)
    tiles = [segs[0][lo : lo + 100] for lo in range(0, 300, 90)]
    want_study, want_exp = study(), asm.run_experiment(segs[0]).columns
    want_vel = vasm.run_external(segs[0], tiles).columns
    profiling.collect()
    with recording():
        got_study = study()
    rec = profiling.collect()
    with recording():
        got_exp = asm.run_experiment(segs[0]).columns
    serial = profiling.collect()
    with recording():
        got_vel = vasm.run_external(segs[0], tiles).columns
    velvet = profiling.collect()

    assert got_study == want_study and len(got_study) == 5  # 3 tables + 2 summaries
    for got, want in ((got_exp, want_exp), (got_vel, want_vel)):
        assert list(got) == list(want)
        for name, col in want.items():
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(col), err_msg=name)
    assert len(want_vel["sequence"]) >= 1
    names = {s.name for s in rec.spans}
    assert RUNNER_SPANS | EVAL_SPANS <= names
    assert COUNTERS <= rec.counters.keys()
    assert rec.counters["merge.calls.native"] == 4  # 3 segments and one filler
    assert sum(s.name == "results.save" for s in rec.spans) == 3
    # the merges ran on the worker, everything else on the main thread
    assert {s.thread for s in rec.spans if s.name == "runner.merge"} != {rec.owner}
    assert {s.thread for s in rec.spans if s.name != "runner.merge"} == {rec.owner}
    assert SERIAL_SPANS | EVAL_SPANS <= {s.name for s in serial.spans}
    assert serial.counters["merge.calls.native"] == 1
    assert 0 < serial.counters["eval.bases"] <= serial.counters["eval.cells"]
    # the serial and the velvet path's evaluation stages hold the same spans
    for one in (serial, velvet):
        stage = next(i for i, s in enumerate(one.spans)
                     if s.name == "Evaluating each de novo assembled solution")
        assert {s.name for s in one.spans if s.parent == stage} == EVAL_SPANS
    assert 0 < velvet.counters["eval.bases"] <= velvet.counters["eval.cells"]


def _save_and_load(workdir, sequence):
    """save_result then load_result_columns of a three-row own table."""
    from genomeassembler_dev_tpu_torch.pipeline import results
    from genomeassembler_dev_tpu_torch.pipeline.assembler import RESULT_COLUMNS, ExperimentResult
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig

    cols = {name: np.arange(3, dtype=np.float32) + 0.5 for name in RESULT_COLUMNS}
    cols["sequence"] = ["ACGT", sequence, "GGTA"]
    path = results.save_result(str(workdir), 1, ExperimentConfig(seq_len=300),
                               ExperimentResult(cols, {}, {}))
    written = profiling.collect().counters
    results.load_result_columns(path)
    return written, profiling.collect().counters


def test_the_results_codec_counts_rows_and_no_fallback_for_dna(tmp_path):
    profiling.collect()
    with recording():
        written, read = _save_and_load(tmp_path, "TTAC")
    assert written == {"results.rows_written": 3} and read == {}


def test_the_results_codec_counts_a_quoted_table_once_each_way(tmp_path):
    profiling.collect()
    with recording():
        written, read = _save_and_load(tmp_path, 'TT"AC')
    assert written == {"results.rows_written": 3, "results.codec_fallback": 1}
    assert read == {"results.codec_fallback": 1}


def test_the_results_codec_counts_nothing_untraced(tmp_path):
    profiling.collect()
    assert _save_and_load(tmp_path, 'TT"AC') == ({}, {})


def test_the_study_counts_tables_aggregated_from_memory_and_reread(tmp_path):
    """A traced study aggregates every table it saved from the fields the
    save formatted and reads back only those of an earlier call; untraced,
    nothing is counted."""
    from genomeassembler_dev_tpu_torch.core.querytable import load_default_query_table
    from genomeassembler_dev_tpu_torch.pipeline.config import ExperimentConfig
    from genomeassembler_dev_tpu_torch.pipeline.experiments import run_own_study
    from genomeassembler_dev_tpu_torch.sim.segments import synthetic_segment_store

    table = load_default_query_table("cpu")
    store = synthetic_segment_store(5, 300, 3)
    base = ExperimentConfig(seq_len=300, coverage_target=12.0, kmer=8, seed=1234,
                            n_orderings=50)

    def study(wd, total_iters, batched):
        run_own_study(str(wd), store, "cpu", base, grid=((12, 9),), total_iters=total_iters,
                      table=table, batched=batched, seg_batch=2)
        return profiling.collect().counters

    profiling.collect()
    assert study(tmp_path / "resumed", 2, True) == {}  # untraced
    with recording():
        fresh = study(tmp_path / "fresh", 3, True)
    with recording():  # the serial loop adds experiment 3 to the untraced call's 2
        resumed = study(tmp_path / "resumed", 3, False)
    assert fresh["study.tables_from_memory"] == 3 and "study.tables_reread" not in fresh
    assert (resumed["study.tables_from_memory"], resumed["study.tables_reread"]) == (1, 2)


def test_trace_writes_the_program_record(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("region"):
            profiling.count("region.calls")
    (path,) = glob.glob(str(tmp_path / "*.program.json"))
    with open(path) as f:
        saved = json.load(f)
    assert saved["counters"] == {"region.calls": 1} == prof.program.counters
    assert [s["name"] for s in saved["spans"]] == ["region"]
    assert not profiling.tracing()


# -- the benchmark's reading of them, on hand-built events -------------------

def _events_and_record():
    """A window of 1000 ns on the main thread (profiler thread 1) with a call
    span, three program spans, one worker span and five kernels with their
    launches: a KS sort and a breakscore dot under their spans, a K1 kernel
    launched under eval.levenshtein, one launched under no span and one of
    another thread."""
    from portbench import spans
    from portbench.trace import SPAN_PREFIX

    E = spans.Event
    evs = [E(SPAN_PREFIX + "window", "annotation", 0, 1000, 1, 0),
           E(SPAN_PREFIX + "call 12:9", "annotation", 10, 990, 1, 0),
           E("cudaLaunchKernel", "launch", 110, 112, 1, 7),
           E("cudaLaunchKernel", "launch", 210, 212, 1, 8),
           E("cudaLaunchKernel", "launch", 310, 312, 1, 9),
           E("cudaLaunchKernel", "launch", 20, 22, 1, 10),
           E("cudaLaunchKernel", "launch", 320, 322, 2, 11),
           E("DeviceSegmentedRadixSortKernel", "device", 120, 170, 0, 7),
           E("gemv_kernel", "device", 220, 240, 0, 8),
           E("myers_kernel<8>", "device", 330, 430, 0, 9),
           E("myers_kernel<8>", "device", 30, 40, 0, 10),
           E("elementwise_kernel", "device", 440, 450, 0, 11),
           E("aten::copy_", "host", 600, 700, 1, 0)]
    S = profiling.Span
    main, worker = 101, 202
    program = [S("Evaluating each de novo assembled solution (grouped)", main, -1, 100, 500),
               S("eval.ks", main, 0, 100, 200),
               S("eval.breakscore", main, 0, 200, 300),
               S("eval.levenshtein", main, 0, 300, 400),
               S("results.save", main, -1, 550, 950),
               S("runner.merge", worker, -1, 500, 900)]
    rec = profiling.Record(program, {"eval.bases": 300, "eval.cells": 400}, main)
    return evs, rec


def test_device_time_goes_to_the_span_open_at_its_launch():
    from portbench import spans

    evs, rec = _events_and_record()
    main = [s for s in rec.spans if s.thread == rec.owner]
    got = spans.device_by_span(evs, main, 1)
    assert got == pytest.approx({"eval.ks": 50e-9, "eval.breakscore": 20e-9,
                                 "eval.levenshtein": 100e-9, "-": 10e-9,
                                 "other threads": 10e-9})
    k1 = spans.device_by_span(evs, main, 1, substring="myers_kernel")
    assert k1 == pytest.approx({"eval.levenshtein": 100e-9, "-": 10e-9})
    assert spans.device_seconds(evs, "myers_kernel") == pytest.approx(110e-9)
    assert spans.device_by_span(evs, main, 1, lo_ns=100, hi_ns=250) == pytest.approx(
        {"eval.ks": 50e-9, "eval.breakscore": 20e-9})
    assert spans.idle_gaps(evs, 0, 1000) == [(0, 30), (40, 120), (170, 220), (240, 330),
                                            (430, 440), (450, 1000)]
    union = spans.Union(main)
    assert union.parts == [[100, 500], [550, 950]]
    assert union.covered_ns(0, 1000) == 400 + 400
    assert union.covered_ns(450, 600) == 50 + 50 and union.covered_ns(960, 990) == 0
    inner = spans.Innermost(main)
    assert inner.at(150).name == "eval.ks"
    assert inner.at(450).name.startswith("Evaluating")
    assert inner.at(520) is None and inner.at(600).name == "results.save"


def test_gaps_are_named_by_harness_program_and_worker_spans():
    from portbench import spans
    from portbench.trace import SPAN_PREFIX

    evs, rec = _events_and_record()
    harness_spans = spans.Innermost([e for e in evs if e.name == SPAN_PREFIX + "call 12:9"])
    main = spans.Innermost([s for s in rec.spans if s.thread == rec.owner])
    worker = spans.Innermost([s for s in rec.spans if s.thread != rec.owner])
    host = [e for e in evs if e.kind == "host"]
    assert spans.label_gap(450, 1000, harness_spans, main, worker, host) == (
        "call 12:9 > results.save (worker: runner.merge): python or native host code")
    assert spans.label_gap(550, 750, harness_spans, main, worker, host) == (
        "call 12:9 > results.save (worker: runner.merge): aten::copy_")
    assert spans.label_gap(90, 150, harness_spans, main, None, host) == (
        "call 12:9 > eval.ks: python or native host code")


def test_the_new_readers_and_the_attribution_report(monkeypatch):
    import sys

    from portbench import attribute, harness, spans

    evs, rec = _events_and_record()
    run = SimpleNamespace(trace=object(), experiments=[object()] * 2, program_record=rec)
    read = {name: harness.metric_reader(name).read(run) for name in (
        "results.save_ms", "eval.pad_fill", "eval.readback_ms", "runner.pack_ms")}
    assert read == {"results.save_ms": pytest.approx(400 / 1e6 / 2), "eval.pad_fill": 0.75,
                    "eval.readback_ms": None, "runner.pack_ms": None}
    # a program without the record, as an older one, reads nothing and does not raise
    monkeypatch.setitem(sys.modules, "genomeassembler_dev_tpu_torch.utils.profiling", None)
    old = SimpleNamespace(trace=object(), experiments=[object()])
    assert harness.metric_reader("results.save_ms").read(old) is None
    assert harness.metric_reader("eval.pad_fill").read(old) is None
    assert spans.record(SimpleNamespace(trace=None)) is None

    report = attribute.analyse(evs, rec, 2)
    assert report["eval.ks_device_ms"] == pytest.approx(1000 * 50e-9 / 2)
    assert report["eval.score_device_ms"] == pytest.approx(1000 * 20e-9 / 2)
    assert report["eval.lev_device_ms"] == pytest.approx(1000 * 100e-9 / 2)
    assert report["k1_device_s"]["all"] == pytest.approx(110e-9)
    assert report["k1_device_s"]["eval.levenshtein"] == pytest.approx(100e-9)
    # idle 30 + 80 + 50 + 90 + 10 + 550 ns, of which the spans cover 20 + 50 + 90 + 10 + 450
    assert report["idle_share_in_program_spans"] == pytest.approx(620 / 810)
    assert report["call_share_outside_spans"]["mean"] == pytest.approx((980 - 800) / 980)
    assert report["idle_gaps"][0] == [
        "call 12:9 > results.save (worker: runner.merge): python or native host code",
        550e-9]
    count, total, own = report["spans_main"][
        "Evaluating each de novo assembled solution (grouped)"]
    assert (count, total, own) == (1, pytest.approx(400 / 1e6 / 2), pytest.approx(100 / 1e6 / 2))
    assert report["eval_spans_ms"] == pytest.approx(300 / 1e6 / 2)
