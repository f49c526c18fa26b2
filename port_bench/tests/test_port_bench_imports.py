"""Nothing the harness loads is JAX or the JAX package: each loaded module's
top-level name (before the first dot) is compared whole, so the port,
``tpu_unet_torch``, is allowed and ``tpu_unet`` is not."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types

from port_bench.run import FORBIDDEN, forbidden_modules

from conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from pathlib import Path
from port_bench.run import execute, forbidden_modules
from port_bench.manifest import Manifest
from port_bench import calibrate
man = Manifest(Path({root!r}))
for kind in ("train_step", "serve_closed_loop"):
    man.generator(kind)
for m in man.data["per_layer"]:
    man.metric_reader(m["name"])
import tpu_unet_torch.serve
execute(man, "attention_carvana.train_bf16", seed=5, seconds=0.2, trace=False,
        device=torch.device("cpu"), t_start=0.0,
        config_overrides={{"image": {{"height": 64, "width": 96}}, "model": {{"base_channels": 4}},
                          "kernels": {{"train": None}}}}, traffic_overrides={{"amp": False}})
print(json.dumps(forbidden_modules()))
"""


def test_a_run_loads_no_jax_module():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_harness_source_imports_jax():
    for path in (ROOT / "port_bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("tpu_unet_torch_extra", "tpu_unet_torch.models", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_unet.models", types.ModuleType("tpu_unet.models"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert forbidden_modules() == ["jax.numpy", "tpu_unet.models"]
