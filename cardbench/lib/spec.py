"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration (`configs/<config>.json`), traffic mix (`traffic/<traffic>.json`),
limits (`limits/<cell>.json`), per-layer readers (`metrics/<metric>.py`), and
its driver (`drivers/<kind>.py`, the mix's `kind`).
"""

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(repo: str = REPO) -> dict:
    return load_json(os.path.join(repo, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    """One workload: its configuration, traffic mix, limits and metrics."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    repo: str = REPO

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def resolve(name: str, bench: dict = None, repo: str = REPO) -> Cell:
    """The cell `name` of `bench` (default: `repo`'s BENCHMARK.json) with
    every file it names loaded from `repo`. Raises KeyError for an unknown
    cell."""
    bench = bench if bench is not None else benchmark(repo)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    data = os.path.join(repo, os.path.relpath(BENCH_DIR, REPO))
    config = dict(load_json(os.path.join(repo, entry["file"])), name=entry["name"])
    traffic = dict(load_json(os.path.join(data, "traffic", w["traffic"] + ".json")),
                   name=w["traffic"])
    limits = load_json(os.path.join(data, "limits", name + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)], repo=repo)


def driver(kind: str):
    """The module that runs a traffic mix of this kind (`drivers/<kind>.py`)."""
    return importlib.import_module(f"cardbench.drivers.{kind}")


def metric_module(metric: str, repo: str = REPO):
    """The module of a per-layer metric's reader (`metrics/<metric>.py` of
    the benchmark in `repo`)."""
    name = "cardbench.metrics." + metric.replace(".", "_").replace("-", "_")
    if repo != REPO:
        name += "@" + repo
    if name not in sys.modules:
        path = os.path.join(repo, os.path.relpath(BENCH_DIR, REPO), "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def reader(metric: str, repo: str = REPO):
    """The `read(ctx)` function of a per-layer metric: None where the trace
    holds nothing for it to read."""
    return metric_module(metric, repo).read
