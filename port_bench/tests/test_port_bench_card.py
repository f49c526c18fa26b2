"""On the card: each cell runs through the benchmark's command and
reads correct, the control of the fp32 cell (TF32) fails a limit, and a run
without a card exits non-zero with no result. The card tests skip without
a CUDA device:

    python -m pytest port_bench/tests -q -m card
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.calibrate import readings
from port_bench.manifest import Manifest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _command(cell: str, seed: int, seconds: int = 2, trace: int = 0) -> list[str]:
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [*data["command"], "--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(_command(cell, 2**31 + 77), capture_output=True, text=True,
                         timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checked"]
    assert out.stderr.strip().splitlines()[-1].startswith("checked ")


@pytest.mark.card
def test_fp32_control_fails_a_limit_on_the_card(card):
    man = Manifest(ROOT)
    cell = "unet_carvana.train_fp32"
    ctl = readings(man, cell, 2**31 + 78, card,
                   {"image": {"height": 320, "width": 480}})["control"]
    limits = man.limits(cell)
    assert any(ctl[k] > limits[k] for k in limits), (ctl, limits)


@pytest.mark.card
def test_benchmark_alone_gives_no_result(card, tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the program is missing: non-zero, nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench")
    out = subprocess.run(_command(CELLS[0], 1), capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_card_no_result():
    """In a process that sees no CUDA device the command exits non-zero and
    prints nothing on standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, *_command(CELLS[0], 1)[1:]], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
