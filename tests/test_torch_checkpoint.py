"""The weight bridge: JAX .npz checkpoints load into the port unchanged and
the port's checkpoints load into the JAX package. Exact: the same float32
arrays cross in both directions."""

import json

import numpy as np
import pytest
import torch

import jax

from tpu_unet.checkpoint import _flatten_with_paths
from tpu_unet.checkpoint import load_checkpoint as j_load
from tpu_unet.checkpoint import save_checkpoint as j_save
from tpu_unet.models import UNetConfig as JConfig
from tpu_unet.models import init_unet as j_init
from tpu_unet_torch.checkpoint import (
    flatten,
    from_jax_arrays,
    load_checkpoint,
    read_checkpoint_meta,
    save_checkpoint,
)
from tpu_unet_torch.models import UNetConfig, init_unet
from tpu_unet_torch.ops import BNState

JCFG = JConfig(3, 1, bilinear=False, base_channels=8)


def _jax_flat(params, state):
    flat = {"params/" + k: v for k, v in _flatten_with_paths(params).items()}
    flat.update({"state/" + k: v for k, v in _flatten_with_paths(state).items()})
    return flat


def test_jax_checkpoint_loads_into_port(tmp_path):
    params, state = j_init(jax.random.PRNGKey(3), JCFG)
    state = jax.tree.map(lambda a: a + 0.1, state)
    path = tmp_path / "jax.npz"
    j_save(path, params, state, mask_values=[0, 255], extra={"config": JCFG._asdict()})

    mask_values, extra = read_checkpoint_meta(path)
    assert mask_values == [0, 255] and extra["config"] == JCFG._asdict()
    tp, ts, mv, ex = load_checkpoint(path, UNetConfig(**extra["config"]))
    assert mv == [0, 255] and ex == extra
    assert isinstance(ts["inc"]["bn1"], BNState)
    ref = _jax_flat(params, state)
    out = flatten(tp, ts)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
        assert out[k].dtype == ref[k].dtype


def test_port_checkpoint_loads_into_jax(tmp_path):
    cfg = UNetConfig(3, 1, base_channels=8)
    tp, ts = init_unet(cfg, np.random.default_rng(5))
    ts["inc"]["bn2"] = BNState(mean=ts["inc"]["bn2"].mean + 0.3, var=ts["inc"]["bn2"].var * 2)
    path = tmp_path / "port.npz"
    save_checkpoint(path, tp, ts, mask_values=[0, 1], extra={"config": cfg._asdict()})

    like_p, like_s = j_init(jax.random.PRNGKey(0), JConfig(**cfg._asdict()))
    jp, js, mv, extra = j_load(path, like_p, like_s)
    assert mv == [0, 1] and extra["config"] == cfg._asdict()
    ref = flatten(tp, ts)
    out = _jax_flat(jp, js)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_from_jax_arrays_on_jax_init_output():
    params, state = j_init(jax.random.PRNGKey(0), JCFG)
    flat = _jax_flat(params, state)
    flat["__meta__"] = np.frombuffer(json.dumps({}).encode(), np.uint8)  # ignored
    tp, ts = from_jax_arrays(flat)
    assert set(tp) == {"inc", "down1", "down2", "down3", "down4", "up1", "up2", "up3", "up4",
                       "outc"}
    assert isinstance(ts["up2"]["conv"]["bn1"], BNState)
    assert tp["up1"]["up"]["w"].shape == (2, 2, 128, 64)
    np.testing.assert_array_equal(tp["outc"]["b"].numpy(), np.asarray(params["outc"]["b"]))
    np.testing.assert_array_equal(ts["down4"]["bn2"].var.numpy(),
                                  np.asarray(state["down4"]["bn2"].var))
    assert all(isinstance(v, torch.Tensor) for v in (tp['inc']['conv1']['w'], ts['inc']['bn1'].mean))


def test_load_checkpoint_validates_against_config(tmp_path):
    params, state = j_init(jax.random.PRNGKey(0), JCFG)
    path = tmp_path / "jax.npz"
    j_save(path, params, state)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(path, UNetConfig(3, 2, base_channels=8))
    trimmed = {k: v for k, v in _jax_flat(params, state).items() if k != "state/up4/conv/bn2/var"}
    trimmed["__meta__"] = np.frombuffer(json.dumps({"mask_values": None}).encode(), np.uint8)
    bad = tmp_path / "bad.npz"
    with open(bad, "wb") as f:
        np.savez(f, **trimmed)
    with pytest.raises(KeyError, match="state/up4/conv/bn2/var"):
        load_checkpoint(bad, UNetConfig(3, 1, base_channels=8))


@pytest.mark.parametrize("stored,want", [(None, "shared"), ("per_step", "per_step"),
                                         ("shared", "shared")])
def test_load_model_defaults_a_missing_recur_bn_to_shared(tmp_path, stored, want):
    """A stored config without ``recur_bn`` predates the per-step layout, so
    predict, evaluate and serve (all through ``load_model``) read it as the
    shared layout; a config that names the layout keeps it."""
    from tpu_unet_torch.predict import load_model

    config = UNetConfig(3, 1, base_channels=8)
    stored_config = config._asdict()
    del stored_config["recur_bn"]
    if stored is not None:
        stored_config["recur_bn"] = stored
    path = tmp_path / "model.npz"
    save_checkpoint(path, *init_unet(config, np.random.default_rng(0)), [0, 1],
                    {"config": stored_config})
    _, extra = read_checkpoint_meta(path)
    assert ("recur_bn" in extra["config"]) == (stored is not None)
    _, _, loaded, mask_values = load_model(path, UNetConfig(3, 1, base_channels=8), "cpu")
    assert loaded.recur_bn == want
    assert loaded._replace(recur_bn=config.recur_bn) == config and mask_values == [0, 1]
