"""The harness finds cells, configurations, traffic mixes, drivers and
metric readers by name from their own files, and BENCHMARK.json keeps to
the benchmark's contract."""

from __future__ import annotations

import json
import os
import re
import time

import pytest
import torch

from conftest import PB, ROOT
from portbench import harness
from portbench import run as runner

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.Cell.find(BENCH, cell)
    assert callable(c.driver().run)
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


def test_missing_cell_raises():
    with pytest.raises(harness.BenchError):
        harness.Cell.find(BENCH, "no_such.cell")


def test_benchmark_json_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(PB, "traffic",
                                           w["traffic"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", ())) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert os.path.isfile(os.path.join(PB, "metrics",
                                           m["name"] + ".py"))
    names = [n["name"] for n in b["configs"] + b["workloads"]
             + b["end_to_end"] + b["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(json.dumps(b)) < 64 * 1024


DRIVER = '''
def run(ctx):
    t = ctx.open_window()
    ctx.read_device()
    ctx.trace.counts["n"] = 3
    return {"e2e": {"widgets_per_s": 42.0}, "attempted": 3, "failed": 0,
            "checks": [("err", 0.0, 1e-6)]}
'''
READER = '''
def read(trace):
    return trace.counts.get("n")
'''


@pytest.mark.parametrize("trace", [0, 1])
def test_a_new_cell_takes_new_files_and_entries_only(tmp_path, trace):
    """A configuration, a mix, a driver and a metric reader added as files,
    with their entries in a copy of BENCHMARK.json: the unchanged harness
    runs the new cell."""
    for d in ("configs", "traffic", "drivers", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "toy.json").write_text('{"limits": {}}')
    (tmp_path / "traffic" / "toy_mix.json").write_text('{"driver": "toy"}')
    (tmp_path / "drivers" / "toy.py").write_text(DRIVER)
    (tmp_path / "metrics" / "widgets_seen.toy.py").write_text(READER)
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy", "source": "x",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "widgets_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy.cell"]})
    bench["per_layer"].append({"name": "widgets_seen.toy", "unit": "1",
                               "better": "higher", "source":
                               "program_counter", "layer": "toy",
                               "moves": "widgets_per_s",
                               "workloads": ["toy.cell"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    args = runner.parse(["--workload", "toy.cell", "--seed", "1",
                         "--seconds", "1", "--trace", str(trace)])
    line = runner.run(args, root=str(tmp_path), bench_path=str(path),
                      device=torch.device("cpu"), t0=time.perf_counter())
    assert line["correct"] is True
    if trace:
        assert line["metrics"] == {"widgets_seen.toy": {"value": 3.0,
                                                        "unit": "1"}}
    else:
        assert set(line["metrics"]) == {"widgets_per_s", "setup_s"}
    assert list(line)[-1] == "checks"


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = runner.main(["--workload", BENCH["workloads"][0]["name"],
                      "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "patchperpix_tpu_torch_x",
                        types.ModuleType("patchperpix_tpu_torch_x"))
    assert "patchperpix_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake",
                        types.ModuleType("jaxlib.fake"))
    assert "jaxlib" in harness.forbidden_modules()
