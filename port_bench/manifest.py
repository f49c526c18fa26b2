"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; each lives in a file of its
own under this package: ``configs/<config>.json``, ``traffic/<traffic>.json``
(whose ``kind`` names the generator, ``generators/<kind>.py``),
``limits/<cell>.json`` (the correctness limits) and
``metrics/<metric>.py`` (a per-layer reader with ``read(readings)``). A
later change adds a cell, a configuration, a mix or a metric as new files
and new entries, and edits none that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PACKAGE = "port_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.pkg = self.root / PACKAGE

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{[w['name'] for w in self.data['workloads']]})")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.pkg / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.pkg / "limits" / f"{cell}.json").read_text())

    def generator(self, kind: str):
        return _load(self.pkg / "generators" / f"{kind}.py", f"{PACKAGE}_generator_{kind}")

    def metric_reader(self, name: str):
        return _load(self.pkg / "metrics" / f"{name}.py",
                     f"{PACKAGE}_metric_{name.replace('.', '_').replace('-', '_')}")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics of ``cell``: those that list it, and those
        without a list whose moved metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        out = []
        for m in self.data["per_layer"]:
            if cell in m["workloads"] if "workloads" in m else m["moves"] in e2e:
                out.append(m)
        return out


def _load(path: Path, module_name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
