"""BENCHMARK.json against the benchmark's contract, and the harness's data
files found by name: a configuration, a traffic kind and a metric added as
new files run without an existing file being edited."""

from __future__ import annotations

import json
import re

import pytest
import torch

from port_bench.manifest import NAME, SOURCES, UNIT, Manifest
from port_bench.run import execute

from conftest import ROOT, TINY_CONFIG

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def data():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names(data):
    assert set(data) == TOP_KEYS
    assert data["paths"] == ["port_bench"]
    assert data["command"][1].startswith("port_bench/") and len(data["command"]) <= 32
    assert isinstance(data["run_seconds"], int) and 1 <= data["run_seconds"] <= 51
    names = []
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("port_bench/configs/") and c["reduced"] == []
        assert ONE_LINE.match(c["why"]) and ONE_LINE.match(c["source"])
        names.append(c["name"])
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and ONE_LINE.match(w["why"])
        names += [w["name"], w["config"], w["traffic"]]
    for m in data["end_to_end"] + data["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    assert len({w["name"] for w in data["workloads"]}) == len(data["workloads"])
    assert len({(w["config"], w["traffic"]) for w in data["workloads"]}) == len(data["workloads"])


def test_end_to_end_bounds_and_layers(data):
    e2e = {m["name"]: m for m in data["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in data["workloads"]}
    for m in data["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert ONE_LINE.match(m["layer"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_every_cell_resolves_its_files():
    man = Manifest(ROOT)
    configs = {c["name"] for c in man.data["configs"]}
    for w in man.data["workloads"]:
        assert w["config"] in configs
        cfg = man.config(w["config"])
        assert cfg["name"] == w["config"]
        traffic = man.traffic(w["traffic"])
        assert callable(man.generator(traffic["kind"]).run)
        assert man.limits(w["name"])
        layer = man.per_layer(w["name"])
        assert layer, w["name"]
        for m in layer:
            assert callable(man.metric_reader(m["name"]).read)
        assert {m["name"] for m in man.end_to_end(w["name"])} >= {"setup_s", "peak_mem_gib"}


NEW_GENERATOR = '''
import time
import torch


def run(ctx):
    x = torch.ones(64, 64, device=ctx.device)
    with ctx.window() as win:
        n = 0
        while time.perf_counter() < win.t0 + ctx.seconds:
            x = x @ x / 64
            n += 1
    return {"attempted": n, "failed": 0, "end_to_end": {"train_img_s": n / win.seconds},
            "numbers": {"gap": 0.0},
            "readings": {"kind": "matmul", "steps": n, "window_s": win.seconds}}
'''
NEW_METRIC = '''
def read(r):
    return r["steps"] / r["window_s"] if r["kind"] == "matmul" else None
'''


def test_a_cell_added_as_files_runs(bench_root):
    before = {p: p.read_bytes() for p in (ROOT / "port_bench").rglob("*.py")}
    bench_root.write("port_bench/configs/tiny.json", json.dumps({"name": "tiny"}))
    bench_root.write("port_bench/traffic/matmul_loop.json", json.dumps({"kind": "matmul_loop"}))
    bench_root.write("port_bench/generators/matmul_loop.py", NEW_GENERATOR)
    bench_root.write("port_bench/metrics/matmuls_per_s.py", NEW_METRIC)
    bench_root.write("port_bench/limits/tiny.matmul_loop.json", json.dumps({"gap": 0.0}))
    bench_root.add("configs", {"name": "tiny", "source": "https://example.org/tiny",
                               "file": "port_bench/configs/tiny.json", "reduced": [],
                               "why": "test"})
    bench_root.add("workloads", {"name": "tiny.matmul_loop", "config": "tiny",
                                 "traffic": "matmul_loop", "chips": 1, "why": "test"})
    data = json.loads((bench_root.path / "BENCHMARK.json").read_text())
    next(m for m in data["end_to_end"] if m["name"] == "train_img_s")["workloads"].append(
        "tiny.matmul_loop")
    (bench_root.path / "BENCHMARK.json").write_text(json.dumps(data))
    bench_root.add("per_layer", {"name": "matmuls_per_s", "unit": "1/s", "better": "higher",
                                 "source": "program_counter", "layer": "matmul",
                                 "moves": "train_img_s", "workloads": ["tiny.matmul_loop"]})
    man = bench_root.manifest()
    for trace in (False, True):
        out = execute(man, "tiny.matmul_loop", seed=3, seconds=0.2, trace=trace,
                      device=torch.device("cpu"), t_start=0.0)
        assert out["correct"] and list(out)[-1] == "checked"
        assert set(out["metrics"]) == ({"matmuls_per_s"} if trace
                                       else {"setup_s", "train_img_s", "peak_mem_gib"})
    assert before == {p: p.read_bytes() for p in (ROOT / "port_bench").rglob("*.py")}


def test_an_existing_cell_runs_from_a_root_with_additions(bench_root):
    bench_root.write("port_bench/metrics/unused.py", NEW_METRIC)
    out = execute(bench_root.manifest(), "unet_carvana.train_bf16", seed=2**31 + 17,
                  seconds=0.5, trace=False, device=torch.device("cpu"), t_start=0.0,
                  config_overrides=TINY_CONFIG, traffic_overrides={"amp": False})
    assert out["attempted"] >= 1 and out["metrics"]["train_img_s"]["value"] > 0
