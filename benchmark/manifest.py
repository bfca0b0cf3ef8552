"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<name>`` is the manifest's workload entry plus
``cells/<name>.json`` (warm-up, trace slice and the limits of the
correctness check); its configuration is ``configs/<config>.json`` and its
traffic ``traffic/<traffic>.json``.  A per-layer metric is read by
``metrics/<metric>.py``, or, where that file is absent, by the reader of the
name without its last dotted part (``pipeline.kf_frame_ms.offline`` falls
back to ``pipeline.kf_frame_ms.py``).  Adding a cell, a configuration, a
traffic mix or a metric is adding files and a manifest entry.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def _line(text: str, what: str) -> str:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text \
            or "\t" in text:
        raise ValueError(f"bad {what} {text!r}")
    return text


def validate(man: dict) -> None:
    """The manifest's names, units and one-line texts against the allowed
    characters, and every cross reference."""
    for key in ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                "per_layer"):
        if key not in man:
            raise ValueError(f"manifest lacks {key}")
    for word in man["command"]:
        _line(word, "command word")
    configs = {check_name(c["name"]) for c in man["configs"]}
    for c in man["configs"]:
        _line(c["source"], "source")
        _line(c["why"], "why")
        for k in c["reduced"]:
            check_name(k)
    cells = set()
    for w in man["workloads"]:
        cells.add(check_name(w["name"]))
        check_name(w["traffic"])
        if w["config"] not in configs:
            raise ValueError(f"cell {w['name']} names unknown config {w['config']}")
        _line(w["why"], "why")
    e2e = set()
    for m in man["end_to_end"] + man["per_layer"]:
        check_name(m["name"])
        if not UNIT.match(m["unit"]):
            raise ValueError(f"bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            raise ValueError(f"bad better {m['better']!r}")
        for w in m.get("workloads", ()):
            if w not in cells:
                raise ValueError(f"metric {m['name']} names unknown cell {w}")
    for m in man["end_to_end"]:
        e2e.add(m["name"])
    for m in man["per_layer"]:
        _line(m["layer"], "layer")
        if m["moves"] not in e2e:
            raise ValueError(f"metric {m['name']} moves unknown {m['moves']}")
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    if len(names) != len(set(names)) or len(cells) != len(man["workloads"]):
        raise ValueError("duplicate metric or cell name")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict                       # cells/<name>.json
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def loop(self) -> str:
        return self.traffic["loop"]


def reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells it lists, or, without
    a list, every cell that reports the end-to-end metric it moves (or, for
    an end-to-end metric, every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"no BENCHMARK.json in {self.root}")
        self.data = _json(path)
        validate(self.data)
        self.bench = self.root / self.data["paths"][0]

    def cell(self, name: str) -> Cell:
        entry = {w["name"]: w for w in self.data["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        spec = _json(self.bench / "cells" / f"{check_name(name)}.json")
        if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
            raise ValueError(f"cells/{name}.json disagrees with BENCHMARK.json")
        config = _json(self.bench / "configs" / f"{check_name(entry['config'])}.json")
        traffic = _json(self.bench / "traffic" / f"{check_name(entry['traffic'])}.json")
        e2e = [m for m in self.data["end_to_end"] if reports(m, name, set())]
        e2e_names = {m["name"] for m in e2e}
        per_layer = [m for m in self.data["per_layer"] if reports(m, name, e2e_names)]
        return Cell(name, int(entry["chips"]), config, traffic, spec, e2e, per_layer)


def reader(name: str, bench: Path = HERE):
    """The ``read(ctx)`` function of a per-layer metric, found by name."""
    check_name(name)
    parts = name.split(".")
    for stem in (name, ".".join(parts[:-1])):
        path = bench / "metrics" / f"{stem}.py"
        if stem and path.is_file():
            mod_name = "benchmark_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", stem)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name} under {bench / 'metrics'}")
