"""BENCHMARK.json against the contract's limits and against the files that
the harness finds by name."""

import json
import os
import re
import shutil

import pytest

from portbench import harness

from .conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return harness.manifest(REPO)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_paths():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert not p.endswith("_torch") and ".." not in p.split("/")
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    b = bench()
    entries = b[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if kind == "configs":
            assert set(e) == {"name", "source", "file", "reduced", "why"}
            assert _line(e["source"]) and _line(e["why"]) and len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
            assert any(e["file"].startswith(p + "/") for p in b["paths"])
        elif kind == "workloads":
            assert set(e) == {"name", "config", "traffic", "chips", "why"}
            assert e["chips"] in (1, 4) and _line(e["why"])
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        else:
            keys = {"name", "unit", "better", "source"}
            keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert keys <= set(e) <= keys | {"workloads"}
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
            if kind == "end_to_end":
                assert e["source"] in ("host_clock", "device_trace")
                assert 0.01 <= e["bound"] <= 0.25
            else:
                assert _line(e["layer"])


def test_every_cell_reports_what_it_must():
    b = bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        reported = harness.cell_metrics(b, w["name"], "end_to_end")
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(b, w["name"], "per_layer")


def test_moves_is_reported_wherever_the_metric_is():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert set(m.get("workloads", [])) <= set(cells)
        for cell in cells:
            if m["name"] in harness.cell_metrics(b, cell, "per_layer"):
                assert m["moves"] in harness.cell_metrics(b, cell, "end_to_end")


@pytest.mark.parametrize("folder,kinds", [("configs", ("configs",)),
                                          ("workloads", ("workloads",)),
                                          ("metrics", ("end_to_end", "per_layer"))])
def test_every_file_is_named_in_the_manifest(folder, kinds):
    """A file that no entry names would go untested and rot."""
    names = {e["name"] for kind in kinds for e in bench()[kind]}
    ext = ".py" if folder == "metrics" else ".json"
    found = {f[: -len(ext)] for f in os.listdir(os.path.join(harness.PKG_DIR, folder))
             if f.endswith(ext)}
    assert found == names


def test_files_agree_with_the_manifest():
    b = bench()
    for c in b["configs"]:
        cfg = harness.config_file(c["name"])
        assert os.path.join(REPO, c["file"]) == os.path.join(
            harness.PKG_DIR, "configs", f"{c['name']}.json")
        assert (cfg["name"], cfg["source"], cfg["reduced"]) == (
            c["name"], c["source"], c["reduced"])
    for w in b["workloads"]:
        wl = harness.workload_file(w["name"])
        assert (wl["config"], wl["traffic"]["name"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    layers = {}
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            mod = harness.metric_reader(m["name"])
            assert (mod.UNIT, mod.SOURCE, mod.BETTER) == (m["unit"], m["source"], m["better"])
            if kind == "per_layer":
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
                layers.setdefault(m["layer"], set()).add(m["name"])
    assert len(layers) >= 5


def test_new_files_are_found_without_editing_any(tmp_path):
    """A later change adds a config, a cell and a metric as new files only."""
    pkg = tmp_path / "portbench"
    shutil.copytree(harness.PKG_DIR, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    cfg = json.loads((pkg / "configs" / "own-1kb.json").read_text())
    cfg["name"] = "own-2kb"
    cfg["experiment"]["seq_len"] = 2000
    (pkg / "configs" / "own-2kb.json").write_text(json.dumps(cfg))
    (pkg / "workloads" / "own2k.k15.json").write_text(json.dumps({
        "config": "own-2kb", "chips": 1, "why": "2 kb rows at k 15",
        "traffic": {"name": "rows_k15_2kb", "rows": [[40, 15]], "total_iters": 8,
                    "repeats": False, "set_seed": 1, "set_size": 8,
                    "check_experiments": 1}}))
    (pkg / "metrics" / "calls_per_s.py").write_text(
        'LAYER = "study"\nUNIT = "calls/s"\nSOURCE = "host_clock"\n'
        'BETTER = "higher"\nMOVES = "experiments_per_s"\n\n\n'
        "def read(run):\n    return len(run.calls) / run.window_s\n")
    b = bench()
    b["configs"].append({"name": "own-2kb", "source": "x", "file": "portbench/configs/own-2kb.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "own2k.k15", "config": "own-2kb",
                           "traffic": "rows_k15_2kb", "chips": 1, "why": "2 kb rows at k 15"})
    b["per_layer"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                           "source": "host_clock", "layer": "study",
                           "moves": "experiments_per_s", "workloads": ["own2k.k15"]})
    assert harness.config_file("own-2kb", str(pkg))["experiment"]["seq_len"] == 2000
    assert harness.workload_file("own2k.k15", str(pkg))["traffic"]["rows"] == [[40, 15]]
    assert "calls_per_s" in harness.cell_metrics(b, "own2k.k15", "per_layer")
    # metrics that name no cells are taken up by the new cell as well
    assert {"merge_ms", "device.idle_share"} <= set(harness.cell_metrics(b, "own2k.k15",
                                                                       "per_layer"))
    assert "experiments_per_s" in harness.cell_metrics(b, "own2k.k15", "end_to_end")
    run = harness.Run("own2k.k15", cfg, {}, 1.0, 2.0, [], calls=[object()] * 3)
    assert harness.metric_reader("calls_per_s", str(pkg)).read(run) == 1.5
    for p, data in before.items():
        assert p.read_bytes() == data
