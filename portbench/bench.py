"""`BENCHMARK.json` and the files it names, found by name:

  * a configuration `<name>` is `configs/<name>.json` (its `file`);
  * a traffic mix `<name>` is `traffic/<name>.json`, whose `driver` names
    `drivers/<driver>.py`;
  * a metric `<name>` is read by `metrics/<name>.py`, or, where there is no
    such file, by `metrics/<base>.py`, base being the name up to its first
    dot (`idle_pct.lat` -> `metrics/idle_pct.py`);
  * the limits of a cell's comparison are `limits/<workload>.json`.

A later change adds a cell, a mix or a metric by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

__all__ = ["ROOT", "HERE", "Bench", "Cell", "NAME", "UNIT", "load", "load_module"]

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


class Bench:
    def __init__(self, data: dict, root: str = ROOT):
        self.data, self.root = data, root

    def _applies(self, metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str) -> Cell:
        w = {x["name"]: x for x in self.data["workloads"]}.get(name)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return Cell(
            name=name, config_name=w["config"], traffic_name=w["traffic"], chips=w["chips"],
            config=_json(os.path.join(HERE, "configs", w["config"] + ".json")),
            traffic=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
            end_to_end=[m for m in self.data["end_to_end"] if self._applies(m, name)],
            per_layer=[m for m in self.data["per_layer"] if self._applies(m, name)],
            limits=_json(os.path.join(HERE, "limits", name + ".json")))


def load(root: str = ROOT) -> Bench:
    return Bench(_json(os.path.join(root, "BENCHMARK.json")), root)


def reader_path(metric: str) -> Optional[str]:
    for n in (metric, metric.split(".", 1)[0]):
        p = os.path.join(HERE, "metrics", n + ".py")
        if os.path.exists(p):
            return p
    return None


def driver_path(traffic: Dict) -> str:
    return os.path.join(HERE, "drivers", traffic["driver"] + ".py")
