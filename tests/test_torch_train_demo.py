"""The port's quality-gate tool (``tpu_unet_torch/tools/train_demo.py``)
against the JAX package's (``tools/train_demo.py``): the frozen recipe
tables are JAX's, ``resolve_recipe`` agrees on every preset, family and
override, a run below its floor exits 1, a toy-size run on the CPU
writes JAX's data and returns JAX's result keys, and a run trains on its
ids sorted (not in the filesystem's ``os.listdir`` order) or in the order
of ``id_seed``'s permutation."""

import itertools

import numpy as np
import pytest
import torch
from PIL import Image

from tools import train_demo as j_demo
import tpu_unet_torch.data as t_data
import tpu_unet_torch.train as t_train
from tpu_unet_torch.tools import train_demo

TABLES = ("PRESETS", "PRESET_GENS", "PRESET_HELDOUT_N", "HELDOUT_SEED", "ARCH_FLOORS", "ARCH_LR",
          "ARCH_OPT")
TOY = (24, 32, 12, 8, 2, 1e-3, 1, 0.0, None)


def test_recipe_tables_are_jaxs():
    for name in TABLES:
        assert getattr(train_demo, name) == getattr(j_demo, name), name


@pytest.mark.parametrize("preset", list(j_demo.PRESETS))
def test_resolve_recipe_agrees_with_jax(preset):
    overrides = [{}, {"epochs_override": 1}, {"optimizer": "sgd"}, {"optimizer": "adam"},
                 {"optimizer": "rmsprop"}, {"lr_override": 3e-4}, {"lr_override": 1.0},
                 {"optimizer": "adam", "lr_override": 3e-4}]
    for arch, kw in itertools.product(j_demo.ARCH_FLOORS, overrides):
        assert (train_demo.resolve_recipe(preset, arch, **kw)
                == j_demo.resolve_recipe(preset, arch, **kw)), (preset, arch, kw)


def test_arch_floors_gate_the_flagship_at_the_arch_preset():
    assert train_demo.resolve_recipe("arch", "unet")[:2] == (0.947, 0.939)
    assert train_demo.resolve_recipe("carvana", "unet")[:2] == (0.988, 0.98)


@pytest.mark.parametrize("argv,kernels", [
    (["--preset", "arch", "--arch", "unetpp"], None),
    (["--preset", "arch", "--arch", "unet", "--kernels", "cuda"], "cuda"),
])
def test_sub_floor_run_exits_nonzero(monkeypatch, capsys, argv, kernels):
    seen = []

    def fake(result):
        def run(*a, **k):
            seen.append((a, k))
            return result
        return run

    monkeypatch.setattr(train_demo, "run", fake({"passed": False, "final_val_dice": 0.1,
                                                 "dice_floor": 0.9}))
    with pytest.raises(SystemExit) as ei:
        train_demo.main(argv + ["--device", "cpu"])
    assert ei.value.code == 1
    assert seen[0][1]["kernels"] == kernels and seen[0][1]["device"] == "cpu"
    monkeypatch.setattr(train_demo, "run", fake({"passed": True}))
    with pytest.raises(SystemExit) as ei:
        train_demo.main(argv)
    assert ei.value.code == 0
    assert '"passed": true' in capsys.readouterr().out


def test_toy_run_writes_jaxs_data_and_returns_jaxs_keys(tmp_path, monkeypatch):
    monkeypatch.setitem(train_demo.PRESETS, "toy", TOY)
    monkeypatch.setitem(j_demo.PRESETS, "toy", TOY)
    calls = []
    real = t_train.train_model

    def train_model(*a, **k):
        calls.append({**k, "deterministic": torch.are_deterministic_algorithms_enabled()})
        return real(*a, **k)

    monkeypatch.setattr(t_train, "train_model", train_model)
    got = train_demo.run("toy", data_dir=tmp_path / "t", device="cpu", kernels="cuda")
    ref = j_demo.run("toy", data_dir=str(tmp_path / "j"))
    assert got.keys() == ref.keys()
    for k in ("preset", "arch", "heldout_seed", "heldout_n", "steps", "lr", "optimizer", "epochs",
              "dice_floor", "heldout_floor", "passed"):
        assert got[k] == ref[k], k
    assert got["device"] == "cpu" and got["steps"] == 5  # 10 train images at batch 2
    assert calls[0]["kernels"] == "cuda" and calls[0]["amp"] is False
    assert calls[0]["val_percent"] == 1 / 6 and calls[0]["device_dataset"] is False
    # Deterministic algorithms inside the run, the previous setting after it.
    assert calls[0]["deterministic"] and not torch.are_deterministic_algorithms_enabled()
    for sub in ("data/imgs", "data/masks", "heldout/imgs", "heldout/masks"):
        names = sorted(p.name for p in (tmp_path / "t" / sub).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "j" / sub).iterdir()) and names
        for name in names:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / sub / name)),
                                          np.asarray(Image.open(tmp_path / "j" / sub / name)))
    # A second run in the same directory reuses the preset's data.
    made = []
    monkeypatch.setattr(t_data, "make_synthetic_carvana",
                        lambda *a, **k: made.append(a))
    again = train_demo.run("toy", data_dir=tmp_path / "t", device="cpu")
    assert not made and again["heldout_n"] == got["heldout_n"]


class _Trained(Exception):
    pass


@pytest.mark.parametrize("id_seed", [None, 5])
def test_run_orders_the_ids(tmp_path, monkeypatch, id_seed):
    monkeypatch.setitem(train_demo.PRESETS, "toy", TOY)
    seen = []

    def train_model(*a, dataset, **k):
        seen.append(list(dataset.ids))
        raise _Trained

    monkeypatch.setattr(t_train, "train_model", train_model)
    with pytest.raises(_Trained):
        train_demo.run("toy", data_dir=tmp_path, device="cpu", id_seed=id_seed)
    names = sorted(p.stem for p in (tmp_path / "data" / "imgs").iterdir())
    want = names if id_seed is None else [
        names[i] for i in np.random.default_rng(id_seed).permutation(len(names))]
    assert seen == [want] and len(names) == TOY[2]
