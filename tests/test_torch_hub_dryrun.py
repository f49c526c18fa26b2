"""The port's hub entries (``hub.py``, ``hubconf.py``), dry-run entry points
(``dryrun.py``) and demo collector (``tools/collect_arch_demos.py``)
against the JAX package's ``hub.py``, ``__graft_entry__.py`` and
``tools/collect_arch_demos.py``, on the CPU. Loaded weights are carried
across and held leaf for leaf; fresh trees (the port cannot draw JAX's
``PRNGKey(0)`` weights) by shape and config."""

import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as j_graft
from tpu_unet import hub as j_hub
from tpu_unet.checkpoint import save_checkpoint as j_save
from tpu_unet.models import UNetConfig as JConfig
from tpu_unet.models import init_unet as j_init
from tpu_unet_torch import dryrun, hub
from tpu_unet_torch.checkpoint import export_pth, flatten, tree_from_numpy
from tpu_unet_torch.models import UNetConfig
from tpu_unet_torch.tools import collect_arch_demos

REPO = Path(__file__).resolve().parents[1]
# The flagship's fp32 eval forward at 64x64, the port's convs against XLA's.
ENTRY_RTOL = 1e-4


def _jax_flat(params, state) -> dict:
    return flatten(tree_from_numpy(jax.tree.map(np.asarray, params)),
                   tree_from_numpy(jax.tree.map(np.asarray, state)))


def _assert_same_trees(got: tuple, want: dict) -> None:
    flat = flatten(*got)
    assert flat.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """JAX's entry(): the flagship's PRNGKey(0) trees and input, saved as a
    JAX checkpoint with a palette, and the same weights as a .pth."""
    fn, (params, state, x) = j_graft.entry()
    d = tmp_path_factory.mktemp("hub")
    npz, pth = d / "flagship.npz", d / "flagship.pth"
    j_save(npz, params, state, mask_values=[0, 255], extra={"config": j_graft.FLAGSHIP._asdict()})
    flat = _jax_flat(params, state)
    port = tree_from_numpy(jax.tree.map(np.asarray, params)), tree_from_numpy(
        jax.tree.map(np.asarray, state))
    export_pth(pth, *port, UNetConfig(*j_graft.FLAGSHIP), mask_values=[0, 255])
    return {"fn": fn, "params": params, "state": state, "x": x, "flat": flat, "npz": npz,
            "pth": pth}


def test_entry_matches_jax(flagship):
    """entry(device="cpu") draws JAX's input and runs the flagship's eval
    forward, which on JAX's weights gives JAX's logits."""
    fn, (params, state, x) = dryrun.entry(device="cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(flagship["x"]))
    out = fn(params, state, x)
    assert out.shape == (1, 64, 64, 2) and torch.isfinite(out).all()
    assert {k: v.shape for k, v in flatten(params, state).items()} == {
        k: v.shape for k, v in flagship["flat"].items()}
    want = np.asarray(flagship["fn"](flagship["params"], flagship["state"], flagship["x"]))
    p, s = tree_from_numpy(jax.tree.map(np.asarray, flagship["params"])), tree_from_numpy(
        jax.tree.map(np.asarray, flagship["state"]))
    got = fn(p, s, x).numpy()
    np.testing.assert_allclose(got, want, rtol=ENTRY_RTOL, atol=ENTRY_RTOL * np.abs(want).max())


def test_unet_carvana_loads_equal_jax(flagship, monkeypatch):
    """pretrained=True from a .npz, a .pth and TPU_UNET_WEIGHTS: the trees and
    palette JAX's hub gives; without weights both raise naming the release
    file; fresh trees have JAX's shapes and config."""
    for path in (flagship["npz"], flagship["pth"]):
        p, s, cfg, mv = hub.unet_carvana(pretrained=True, weights_path=str(path), device="cpu")
        jp, js, jcfg, jmv = j_hub.unet_carvana(pretrained=True, weights_path=str(path))
        _assert_same_trees((p, s), _jax_flat(jp, js))
        assert cfg._asdict() == jcfg._asdict() and mv == jmv == [0, 255]
    _assert_same_trees(hub.unet_carvana(pretrained=True, weights_path=str(flagship["npz"]),
                                        device="cpu")[:2], flagship["flat"])
    monkeypatch.setenv("TPU_UNET_WEIGHTS", str(flagship["pth"]))
    _assert_same_trees(hub.unet_carvana(pretrained=True, device="cpu")[:2], flagship["flat"])
    monkeypatch.delenv("TPU_UNET_WEIGHTS")
    for make in (j_hub.unet_carvana, lambda **kw: hub.unet_carvana(device="cpu", **kw)):
        with pytest.raises(RuntimeError, match="unet_carvana_scale1.0_epoch2.pth"):
            make(pretrained=True, scale=1.0)
    p, s, cfg, mv = hub.unet_carvana(device="cpu")
    assert cfg._asdict() == j_graft.FLAGSHIP._asdict() and mv is None
    assert {k: v.shape for k, v in flatten(p, s).items()} == {
        k: v.shape for k, v in flagship["flat"].items()}
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hub.unet_carvana()


def test_unet_family_entries_match_jax(tmp_path, caplog):
    """``unet``: a .npz's stored config wins over the caller's (logged), a
    .pth loads for the U-Net only, and ``bilinear=None`` picks each family's
    decoder; fresh trees have JAX's shapes."""
    att = JConfig(3, 1, bilinear=True, base_channels=8, arch="attention")
    jp, js = j_init(jax.random.PRNGKey(3), att)
    npz = tmp_path / "att.npz"
    j_save(npz, jp, js, mask_values=[0, 1], extra={"config": att._asdict()})
    with caplog.at_level(logging.INFO, logger="tpu_unet_torch.hub"):
        p, s, cfg, mv = hub.unet(base_channels=8, weights_path=str(npz), device="cpu")
    assert any("using its config over the caller's" in r.getMessage() for r in caplog.records)
    jp2, js2, jcfg, jmv = j_hub.unet(base_channels=8, weights_path=str(npz))
    assert cfg._asdict() == jcfg._asdict() == att._asdict() and mv == jmv == [0, 1]
    _assert_same_trees((p, s), _jax_flat(jp2, js2))

    flat_cfg = JConfig(3, 1, bilinear=False, base_channels=8)
    up, us = j_init(jax.random.PRNGKey(4), flat_cfg)
    pth = tmp_path / "u.pth"
    export_pth(pth, tree_from_numpy(jax.tree.map(np.asarray, up)),
               tree_from_numpy(jax.tree.map(np.asarray, us)), UNetConfig(*flat_cfg))
    kw = dict(n_classes=1, base_channels=8, weights_path=str(pth))
    p, s, cfg, _ = hub.unet(device="cpu", **kw)
    jp3, js3, jcfg3, _ = j_hub.unet(**kw)
    assert cfg._asdict() == jcfg3._asdict()
    _assert_same_trees((p, s), _jax_flat(jp3, js3))
    for make in (j_hub.unet, lambda **k: hub.unet(device="cpu", **k)):
        with pytest.raises(ValueError, match="pth import is reference-layout"):
            make(arch="attention", **kw)

    for arch in ("unet", "unetpp", "attention", "r2u", "r2attu"):
        p, s, cfg, mv = hub.unet(arch=arch, base_channels=8, device="cpu")
        jp4, js4, jcfg4, _ = j_hub.unet(arch=arch, base_channels=8)
        assert cfg._asdict() == jcfg4._asdict() and cfg.bilinear == (arch != "unet")
        assert mv is None
        assert {k: v.shape for k, v in flatten(p, s).items()} == {
            k: v.shape for k, v in _jax_flat(jp4, js4).items()}


def test_torch_hub_load_of_the_port(flagship):
    """torch.hub.load of ``tpu_unet_torch/hubconf.py`` with source="local"
    (only that directory on sys.path) reaches both entries."""
    got = torch.hub.load(str(REPO / "tpu_unet_torch"), "unet_carvana", source="local",
                         pretrained=True, weights_path=str(flagship["pth"]), device="cpu")
    _assert_same_trees(got[:2], flagship["flat"])
    assert got[3] == [0, 255]
    p, s, cfg, _ = torch.hub.load(str(REPO / "tpu_unet_torch"), "unet", source="local",
                                  arch="r2u", base_channels=8, device="cpu")
    assert cfg.arch == "r2u" and cfg.bilinear and "down4" in p


def test_dryrun_multichip_core_tier_in_a_subprocess():
    """dryrun_multichip(2) on 2 gloo ranks (no GPU here) with budget 0: the
    core tier runs and passes, the extended tier is skipped."""
    code = "from tpu_unet_torch.dryrun import dryrun_multichip; dryrun_multichip(2)"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env={**os.environ,
                                           "TPU_UNET_DRYRUN_BUDGET_S": "0",
                                           "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stdout + out.stderr
    for line in ("2 ranks: gloo on the CPU", "ok dp-train (core)", "ok zero1 (core)",
                 "ok halo-inference (core)", "SKIP accum", "SKIP cuda-kernels-dp",
                 "ran 3 sections"):
        assert line in out.stdout, out.stdout


def test_section_runner_budget():
    """A core section that would start past the budget plus the grace fails
    at the boundary, by name, without running; an extended section runs only
    while its estimate fits; ``agree`` decides for every rank."""
    ran = []
    runner = dryrun.SectionRunner(-dryrun.CORE_GRACE_S - 1.0, say=ran.append)
    with pytest.raises(RuntimeError, match="over budget before section 'zero1'"):
        runner.run("zero1", lambda: ran.append("called"), core=True)
    assert "called" not in ran and ran[-1].startswith("[dryrun] FAIL zero1 (core)")
    runner = dryrun.SectionRunner(0.0, say=ran.append)
    assert runner.run("dp-train", lambda: None, core=True)
    assert not runner.run("accum", lambda: ran.append("called"))
    assert runner.skipped == ["accum"] and "called" not in ran
    runner = dryrun.SectionRunner(1000.0, agree=lambda flag: True, say=ran.append)
    assert not runner.run("accum", lambda: ran.append("called"))  # rank 0 said skip
    assert dryrun.SectionRunner(1000.0, say=ran.append).run("accum", lambda: None)


def test_collector_matches_jax_tool(tmp_path, capsys):
    """On two records, the port's collector writes what the JAX tool writes
    (the records renamed arch_*.json for it) and prints the same floors;
    the committed ARCH_DEMOS_TORCH.json is the collection of demo_runs."""
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    for arch in ("unet", "r2u"):
        shutil.copy(REPO / "demo_runs" / f"torch_arch_{arch}.json", ours)
        shutil.copy(REPO / "demo_runs" / f"torch_arch_{arch}.json", theirs / f"arch_{arch}.json")
    j_out = subprocess.run([sys.executable, str(REPO / "tools" / "collect_arch_demos.py"),
                            "--runs", str(theirs), "--out", str(tmp_path / "j.json")],
                           capture_output=True, text=True, timeout=120)
    assert j_out.returncode == 0, j_out.stderr
    collect_arch_demos.main(["--runs", str(ours), "--out", str(tmp_path / "t.json")])
    printed = capsys.readouterr().out
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert printed.splitlines()[1:] == j_out.stdout.splitlines()[1:]
    assert set(json.loads((tmp_path / "t.json").read_text())) == {"unet", "r2u"}
    committed = json.loads((REPO / "ARCH_DEMOS_TORCH.json").read_text())
    assert committed == collect_arch_demos.collect(REPO / "demo_runs")
    assert set(committed) == {"unet", "unetpp", "attention", "r2u", "r2attu"}
    with pytest.raises(SystemExit, match="no torch_arch_"):
        collect_arch_demos.main(["--runs", str(theirs), "--out", str(tmp_path / "x.json")])
