"""Tests of the benchmark harness. They run on the CPU at small sizes; the
few that need a CUDA card carry the ``card`` marker and skip without one,
decided in the ``card`` fixture (never while a module is imported).

    python -m pytest port_bench/tests -q
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Small sizes for CPU runs: the widths of a cell are kept in its own
# configuration; these tests check the harness, not the model's widths.
TINY_CONFIG = {"image": {"height": 128, "width": 192}, "model": {"base_channels": 8},
               "kernels": {"train": None, "serve": "torch"}}
SERVE_TRAFFIC = {"clients": 4, "max_batch": 4, "warm_canvases": [1, 4], "warm_seconds": 0.3,
                 "pool_images": 8, "sample_per_client": 2}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def bench_root(tmp_path):
    """A copy of BENCHMARK.json and the package under a temporary root,
    with ``add(section, entry)`` to add manifest entries and ``write(path,
    text)`` to add files: nothing of the repository is edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))

    class Root:
        path = tmp_path

        def add(self, section: str, entry: dict):
            data = json.loads((tmp_path / "BENCHMARK.json").read_text())
            data[section].append(entry)
            (tmp_path / "BENCHMARK.json").write_text(json.dumps(data, indent=1))

        def write(self, rel: str, text: str):
            p = tmp_path / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(text)

        def manifest(self):
            from port_bench.manifest import Manifest

            return Manifest(tmp_path)

    return Root()


def add_serve_cell(root, mask_gap_limit: float = 0.5):
    """The serve cell, kept out of BENCHMARK.json while the card idles most
    of its window (PERF.md), added to a temporary root with its metrics."""
    root.add("workloads", {"name": "unet_carvana.serve_c16", "config": "unet_carvana",
                           "traffic": "serve_c16", "chips": 1, "why": "test"})
    for name, unit, better in (("serve_img_s", "img/s", "higher"), ("serve_p95_ms", "ms", "lower")):
        root.add("end_to_end", {"name": name, "unit": unit, "better": better, "bound": 0.05,
                                "source": "host_clock", "workloads": ["unet_carvana.serve_c16"]})
    root.write("port_bench/limits/unet_carvana.serve_c16.json",
               json.dumps({"mask_gap": mask_gap_limit}))
