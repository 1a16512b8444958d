"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` takes ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<config>.json``, and the module
``archs/<arch>.py`` of the architecture that the configuration names under
``"arch"``; a metric ``<name>`` takes the reader ``metrics/<name>.py``, or
``metrics/<base>.py`` for a ``<base>.<suffix>`` that has none of its own.
Adding a cell, a mix, a configuration, an architecture or a metric is adding
files and entries: no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark_torch/
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    moves: Optional[str] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    arch: ModuleType  # archs/<arch>.py of the configuration
    traffic: Dict
    limits: Dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: str) -> Dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_benchmark(root: str) -> Dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _metrics(entries, cell: str) -> List[Metric]:
    out = []
    for e in entries:
        m = Metric(e["name"], e["unit"], e["better"], e["source"], e.get("workloads"), e.get("moves"))
        if m.applies_to(cell):
            out.append(m)
    return out


def bench_dir(root: str) -> str:
    """The checkout's copy of this folder."""
    return os.path.join(root, os.path.basename(HERE))


def find_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files in the
    checkout. Raises ``KeyError`` for a name the file does not hold and for
    a configuration that names no architecture, ``FileNotFoundError`` where
    a file is missing."""
    bench = load_benchmark(root)
    here = bench_dir(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    if "arch" not in config:
        raise KeyError(f"configuration {entry['config']!r} names no architecture (\"arch\")")
    e2e = _metrics(bench["end_to_end"], name)
    per_layer = _metrics(bench["per_layer"], name)
    return Cell(
        name=name,
        config_name=entry["config"],
        traffic_name=entry["traffic"],
        chips=int(entry["chips"]),
        config=config,
        arch=arch(config["arch"], root),
        traffic=_load_json(os.path.join(here, "traffic", f"{entry['traffic']}.json")),
        limits=_load_json(os.path.join(here, "limits", f"{entry['config']}.json")),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def _load(path: str, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module  # as an import would: dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def arch(name: str, root: str = os.path.dirname(HERE)) -> ModuleType:
    """The architecture module ``archs/<name>.py``. Raises ``KeyError`` for
    a name that is not one, ``FileNotFoundError`` where no such file is."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise KeyError(f"{name!r} is not an architecture's name")
    path = os.path.join(bench_dir(root), "archs", f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no architecture module archs/{name}.py")
    return _load(path, f"benchmark_arch_{name.replace('-', '_').replace('.', '_')}")


def reader(name: str, root: str = os.path.dirname(HERE)) -> Callable:
    """``metrics/<name>.py``'s ``read(record)``: a number, or ``None`` where
    the run holds nothing for it to read. A metric ``<base>.<suffix>`` (one
    quantity split by the end-to-end metric it moves) without a file of its
    own takes ``metrics/<base>.py``."""
    folder = os.path.join(bench_dir(root), "metrics")
    path = os.path.join(folder, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(folder, f"{name.split('.')[0]}.py")
    return _load(path, f"benchmark_metric_{name.replace('.', '_')}").read
