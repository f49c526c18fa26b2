"""The port's optimizer menu and LR schedules against the JAX package's, on
the CPU in fp32: three steps of SGD (plain and Nesterov), Adam, AdamW and
RMSprop through ``get_optimizer`` on the same params and gradients (made
with numpy), and the plateau, cosine, step and constant schedules over the
same metric sequence, with ``state_dict`` round trips.

Tolerances: params and state after three steps 1e-6 absolute + 1e-6
relative (the same fp32 formulas; Adam's bias correction is one pow each);
learning rates 1e-12 relative (host-side float64 arithmetic in both).
"""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.optim import get_optimizer as j_get_optimizer, get_scheduler as j_get_scheduler
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.optim import (
    AdamState,
    ReduceLROnPlateau,
    SGDState,
    get_optimizer,
    get_scheduler,
)

ATOL = RTOL = 1e-6


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, tuple):
        return {k2: v2 for k, v in zip(tree._fields, tree)
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach()
    return {prefix: np.asarray(tree, np.float64)}


def _params(rng):
    return {"conv": {"w": rng.standard_normal((3, 3, 4, 5), dtype=np.float32)},
            "bn": {"scale": 1 + 0.1 * rng.standard_normal(5, dtype=np.float32),
                   "bias": rng.standard_normal(5, dtype=np.float32)}}


def _grads(rng, params):
    return {k: {n: rng.standard_normal(v.shape, dtype=np.float32) for n, v in d.items()}
            for k, d in params.items()}


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {}), ("sgd", {"nesterov": True}), ("sgd", {"momentum": 0.5, "weight_decay": 1e-2}),
    ("adam", {}), ("adam", {"weight_decay": 1e-2}), ("adamw", {"weight_decay": 1e-2}),
    ("rmsprop", {}),
])
def test_optimizer_steps_match_jax(name, kwargs):
    rng = np.random.default_rng(0)
    params = _params(rng)
    grads = [_grads(rng, params) for _ in range(3)]
    j_init, j_update = j_get_optimizer(name, **kwargs)
    t_init, t_update = get_optimizer(name, **kwargs)
    jp = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in params.items()}
    tp = tree_from_numpy(params)
    js, ts = j_init(jp), t_init(tp)
    assert type(ts).__name__ == type(js).__name__ and ts._fields == js._fields
    for step, g in enumerate(grads):
        lr = 1e-2 * (step + 1)
        jp, js = j_update({k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in g.items()},
                          js, jp, lr)
        tp, ts = t_update(tree_from_numpy(g), ts, tp, lr)
    for got, ref in ((tp, jp), (ts, js)):
        g, r = _flat(got), _flat(ref)
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], atol=ATOL, rtol=RTOL, err_msg=k)
    if name.startswith("adam"):
        assert isinstance(ts, AdamState) and ts.step.dtype == torch.int32 and int(ts.step) == 3
    if name == "sgd":
        assert isinstance(ts, SGDState)


def test_optimizer_keeps_param_dtype_and_state_fp32():
    params = {"w": torch.ones(3, dtype=torch.bfloat16)}
    init, update = get_optimizer("adamw", weight_decay=1e-2)
    state = init(params)
    new, state = update({"w": torch.full((3,), 0.5, dtype=torch.bfloat16)}, state, params, 1e-2)
    assert new["w"].dtype == torch.bfloat16
    assert state.exp_avg["w"].dtype == torch.float32


def test_get_optimizer_refuses():
    with pytest.raises(ValueError, match="nesterov"):
        get_optimizer("adam", nesterov=True)
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("lbfgs")
    with pytest.raises(ValueError, match="unknown lr scheduler"):
        get_scheduler("linear", 1e-3)


METRICS = [0.1, 0.2, 0.2, 0.19, 0.2, 0.2, 0.2, 0.2, 0.2, 0.3, -0.5, -0.4, -0.4, -0.41,
           -0.42, -0.43, -0.44, -0.45, -0.46]


@pytest.mark.parametrize("name,kwargs", [
    ("plateau", {}), ("plateau", {"patience": 1}), ("cosine", {"epochs": 7, "eta_min": 1e-5}),
    ("step", {"step_size": 3, "gamma": 0.5}), ("constant", {}),
])
def test_scheduler_matches_jax_and_round_trips(name, kwargs):
    j_s = j_get_scheduler(name, 1e-2, **kwargs)
    t_s = get_scheduler(name, 1e-2, **kwargs)
    seq_j, seq_t = [], []
    for i, m in enumerate(METRICS):
        seq_j += [j_s.step(m), j_s.epoch_end() if i % 3 == 2 else j_s.lr]
        seq_t += [t_s.step(m), t_s.epoch_end() if i % 3 == 2 else t_s.lr]
        if i == 8:
            # Round trip through the state dict, as a checkpoint carries it
            # (JSON: infinities and all), into a fresh schedule.
            state = t_s.state_dict()
            assert state == j_s.state_dict()
            t_s = get_scheduler(name, 1.0, **kwargs)
            t_s.load_state_dict(json.loads(json.dumps(state)))
            assert t_s.state_dict() == state
    np.testing.assert_allclose(seq_t, seq_j, rtol=1e-12)
    assert t_s.state_dict() == j_s.state_dict()


def test_plateau_semantics():
    """torch's rules: better means above best·(1 + 1e-4); the rate drops
    after more than ``patience`` bad validations, then the count resets."""
    s = ReduceLROnPlateau(lr=1.0, patience=2)
    assert s.best == -math.inf
    lrs = [s.step(m) for m in (0.5, 0.50001, 0.4, 0.4, 0.4, 0.6)]
    # 0.50001 is not above 0.5·1.0001: bad validations 1, 2, 3 > 2 -> drop.
    assert lrs == [1.0, 1.0, 1.0, 0.1, 0.1, 0.1]
    assert s.best == 0.6 and s.num_bad_epochs == 0
