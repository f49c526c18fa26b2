"""``tpu_unet_torch/tools/route_gap.py`` on the CPU: the swap binds
``ops/conv_stats.py``'s name of one train kernel to its plain version for
one run only and restores it after, a real toy run at base 8 trains
through it, and the summary's paired gaps are the mean, standard error and
Student's-t interval of the per-order differences."""

import json
import math
import statistics

import pytest

import tpu_unet_torch.train as t_train
from tpu_unet_torch.kernels import train_conv
from tpu_unet_torch.ops import conv_stats
from tpu_unet_torch.tools import route_gap, train_demo

TOY = (24, 32, 12, 8, 2, 1e-3, 1, 0.0, None)
NAMES = ("conv3x3_fwd", "conv3x3_dx", "conv3x3_dw")


class _Trained(Exception):
    pass


def _bound():
    return {n: getattr(conv_stats, n) for n in NAMES}


@pytest.mark.parametrize("which", list(route_gap.PLAIN))
def test_swap_is_the_plain_function_for_the_run_only(tmp_path, monkeypatch, which):
    monkeypatch.setitem(train_demo.PRESETS, "toy", TOY)
    seen = []

    def train_model(*a, kernels, **k):
        seen.append((kernels, _bound()))
        raise _Trained

    monkeypatch.setattr(t_train, "train_model", train_model)
    with pytest.raises(_Trained):
        route_gap.run_route("toy", 3, tmp_path, kernels="cuda", plain=which, device="cpu")
    name = route_gap.PLAIN[which]
    kernels, during = seen[0]
    assert kernels == "cuda"
    assert during[name] is getattr(train_conv, f"{name}_plain")
    assert all(during[n] is getattr(train_conv, n) for n in NAMES if n != name)
    assert _bound() == {n: getattr(train_conv, n) for n in NAMES}


def test_a_toy_run_trains_through_the_swap_and_restores_it(tmp_path, monkeypatch):
    monkeypatch.setitem(train_demo.PRESETS, "toy", TOY)
    calls = []
    plain = train_conv.conv3x3_dw_plain

    def spy(*a, **k):
        calls.append(a[0].shape)
        return plain(*a, **k)

    monkeypatch.setattr(train_conv, "conv3x3_dw_plain", spy)
    r = route_gap.run_route("toy", 1, tmp_path, kernels="cuda", plain="dw", device="cpu")
    assert r["route"] == "cuda+plain_dw" and r["id_seed"] == 1 and r["deterministic"]
    assert r["steps"] > 0 and math.isfinite(r["heldout_dice"]) and calls
    assert conv_stats.conv3x3_dw is train_conv.conv3x3_dw


def test_a_swap_on_the_library_route_is_refused(tmp_path):
    with pytest.raises(ValueError, match="cuda route"):
        route_gap.run_route("toy", 0, tmp_path, kernels=None, plain="fwd", device="cpu")


def test_paired_gaps_and_main_write_one_json_a_run(tmp_path, monkeypatch):
    held = {("torch", 0): 0.97, ("torch", 1): 0.98, ("torch", 2): 0.96,
            ("cuda", 0): 0.95, ("cuda", 1): 0.985, ("cuda", 2): 0.94}

    def run_route(preset, seed, data_dir, kernels, plain, det, device, arch):
        route = route_gap.route_name(kernels, plain, det)
        return {"route": route, "id_seed": seed, "heldout_dice": held[route, seed],
                "final_val_dice": 0.99, "train_wall_s": 1.0, "passed": True}

    monkeypatch.setattr(route_gap, "run_route", run_route)
    route_gap.main(["--preset", "arch", "--orders", "3", "--out-dir", str(tmp_path),
                    "--device", "cpu"])
    assert len(list(tmp_path.glob("arch_unet_*_id*.json"))) == 6
    s = json.loads((tmp_path / "summary_arch_unet.json").read_text())["heldout_dice"]["cuda"]
    gaps = [-0.02, 0.005, -0.02]
    se = statistics.stdev(gaps) / math.sqrt(3)
    assert s["n"] == 3 and s["below"] == 2
    assert s["mean"] == pytest.approx(statistics.fmean(gaps))
    assert s["se"] == pytest.approx(se)
    assert s["ci95"] == pytest.approx([s["mean"] - 4.303 * se, s["mean"] + 4.303 * se])
