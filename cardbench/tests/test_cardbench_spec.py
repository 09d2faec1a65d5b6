"""BENCHMARK.json against the contract's letter, every name resolved to its
files, and a new cell added by files and entries alone."""

import json
import os
import re
import shutil

import pytest
import torch

from cardbench import run
from cardbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return spec.benchmark()


def one_line(text, most=200):
    return (isinstance(text, str) and 1 <= len(text) <= most
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert 1 <= len(b["paths"]) <= 16 and len(b["command"]) <= 32
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(spec.REPO, p))
    for word in b["command"]:
        assert one_line(word) and not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in b["paths"])
    assert os.path.getsize(os.path.join(spec.REPO, "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_the_contract_keys_and_names():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and one_line(w["why"])
    cells = {w["name"] for w in b["workloads"]}
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names and len(b["configs"]) == len({c["name"] for c in b["configs"]})


def test_per_layer_metric_reports_its_moved_metric():
    """A per-layer metric's cells all report the end-to-end metric it moves."""
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]].get("workloads")
        if moved is not None:
            assert set(m["workloads"]) <= set(moved), m["name"]


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    c = spec.resolve(cell)
    assert c.config["reduced"] == []
    assert {"kind", "why"} <= set(c.traffic) and hasattr(spec.driver(c.kind), "run")
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    assert "setup_s" in {m["name"] for m in c.end_to_end} and len(c.end_to_end) >= 2
    assert c.per_layer and all(callable(spec.reader(m["name"])) for m in c.per_layer)
    from cardbench import reference
    assert callable(reference.module(c.config["arch"]).forward)


def test_new_cell_from_files_and_entries_alone(tmp_path):
    """A copy of the benchmark's data gains a configuration, a traffic mix,
    a per-layer metric and a cell by new files and new entries only; the
    cell resolves and runs on the CPU."""
    data = tmp_path / "cardbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, sub), data / sub)
    b = bench()
    cfg = json.loads((data / "configs" / "NestedUNet_wDS.json").read_text())
    cfg.update(nb_filter=[4, 8, 16, 32, 64], input_hw=[32, 32])
    (data / "configs" / "NestedUNet_narrow.json").write_text(json.dumps(cfg))
    tr = json.loads((data / "traffic" / "train.b128.json").read_text())
    tr.update(batch=4, set_size=24, why="a narrow mix")
    (data / "traffic" / "train.b4.json").write_text(json.dumps(tr))
    (data / "limits" / "NestedUNet_narrow.train.b4.json").write_text(
        json.dumps({"loss_gap": 1.0, "grad_gap": 10.0, "change_gap": 10.0}))
    (data / "metrics" / "steps_traced.train.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    b["configs"].append({"name": "NestedUNet_narrow", "source": "a test",
                         "file": "cardbench/configs/NestedUNet_narrow.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "NestedUNet_narrow.train.b4", "config": "NestedUNet_narrow",
                           "traffic": "train.b4", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "steps",
                           "moves": "train_img_per_s",
                           "workloads": ["NestedUNet_narrow.train.b4"]})
    b["end_to_end"][0]["workloads"].append("NestedUNet_narrow.train.b4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.resolve("NestedUNet_narrow.train.b4", repo=str(tmp_path))
    assert cell.traffic["batch"] == 4 and cell.config["nb_filter"][0] == 4
    assert [m["name"] for m in cell.per_layer][-1] == "steps_traced.train"
    cell.traffic["trace_seconds"] = 0.2
    assert run.main(["--workload", cell.name, "--seed", "5", "--seconds", "0.2", "--trace", "1"],
                    device=torch.device("cpu"), cell=cell) == 0
