"""The port's train slice against the JAX package on CPU, fp32, at base 8
and 33x20 pixels (odd H: the decoder pads) with batch 2: ``synth_batch``,
the losses, RMSprop and clipping, ``unet_apply`` in train and eval mode
with both decoders, and ``make_train_step`` against JAX's
``make_train_step`` (``kernels=None`` against the XLA step; ``"cuda"``,
whose wrappers run their plain versions on the CPU, against
``kernels="pallas"`` in interpret mode).

Tolerances:
- losses, clip norm: 1e-6 + 1e-6 relative; RMSprop on identical gradients
  (params and both buffers, the momentum buffer of order 10): 1e-5 + 1e-5;
- logits and BN running stats of a forward: 1e-4 + 1e-4;
- one train step: loss 1e-5 relative; every gradient within 1e-3 of its
  largest magnitude (+1e-6); grad norm 1e-4 relative; BN running stats
  1e-4 + 1e-4; RMSprop square_avg 1e-3 relative + 1e-9; updated params 2e-2
  absolute at lr 1e-3 (RMSprop's first step divides g by about 0.1·|g|, so a
  near-zero gradient whose sign differs in the last bits moves its weight by
  ±lr·10 either way, as ``tests/test_parallel.py`` allows);
- the 3-step loss history: 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_unet.data.synthetic import synth_batch as j_synth_batch
from tpu_unet.losses import (
    bce_with_logits as j_bce,
    cross_entropy as j_ce,
    dice_coeff as j_dice_coeff,
    dice_loss as j_dice_loss,
    iou_coeff as j_iou,
)
from tpu_unet.models import UNetConfig as JConfig, init_unet as j_init_unet, unet_apply as j_apply
from tpu_unet.optim import (
    clip_grad_norm as j_clip,
    rmsprop_init as j_rms_init,
    rmsprop_update as j_rms_update,
)
from tpu_unet.train import compute_loss as j_compute_loss, make_train_step as j_make_step
from tpu_unet_torch import kernels as K
from tpu_unet_torch.checkpoint import tree_from_numpy
from tpu_unet_torch.data import synth_batch
from tpu_unet_torch.losses import bce_with_logits, cross_entropy, dice_coeff, dice_loss, iou_coeff
from tpu_unet_torch.models.unet import UNetConfig, unet_apply
from tpu_unet_torch.ops import BNState
from tpu_unet_torch.optim import RMSpropState, clip_grad_norm, rmsprop_init, rmsprop_update
from tpu_unet_torch.train import compute_loss, make_train_step

H, W, B, BASE, LR = 33, 20, 2, 8, 1e-3


def _flat(tree, prefix=""):
    """{keypath: numpy array} of a JAX or port tree (dicts, NamedTuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float()
    return {prefix: np.asarray(tree, np.float32)}


def _assert_trees(got, ref, *, atol=0.0, rtol=0.0, scale=0.0):
    """Each leaf: |got - ref| <= atol + rtol * |ref| + scale * max |ref|."""
    g, r = _flat(got), _flat(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        bound = atol + scale * np.abs(r[k]).max()
        np.testing.assert_allclose(g[k], r[k], atol=bound, rtol=rtol, err_msg=k)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _copy(tree):
    return jax.tree.map(jnp.array, tree)


def test_synth_batch_matches_jax():
    ji, jm = j_synth_batch(np.random.default_rng(7), 3, H, W)
    ti, tm = synth_batch(np.random.default_rng(7), 3, H, W)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    assert ti.dtype == np.float32 and tm.dtype == np.int64 and ti.shape == (3, H, W, 3)


def test_tree_from_numpy_maps_named_tuples():
    params, state = j_init_unet(jax.random.PRNGKey(0), JConfig(3, 1, False, 4))
    opt = _numpy(j_rms_init(params))
    tp, ts, to = (tree_from_numpy(t) for t in (_numpy(params), _numpy(state), opt))
    assert isinstance(to, RMSpropState) and isinstance(ts["up1"]["conv"]["bn2"], BNState)
    _assert_trees(tp, params)
    _assert_trees(ts, state)
    _assert_trees(to, opt)
    with pytest.raises(TypeError, match="no port counterpart"):
        tree_from_numpy((np.zeros(2),))


@pytest.mark.parametrize("case", ["binary", "multiclass", "empty"])
def test_losses_match_jax(rng, case):
    if case == "multiclass":
        logits = rng.standard_normal((2, 7, 9, 4)).astype(np.float32)
        masks = rng.integers(0, 4, (2, 7, 9))
    else:
        logits = rng.standard_normal((2, 7, 9, 1)).astype(np.float32)
        masks = (rng.random((2, 7, 9)) > 0.6).astype(np.int64)
        if case == "empty":
            logits = logits - 40.0  # sigmoid ~ 0 and an empty mask: Dice 1
            masks[:] = 0
    nc = logits.shape[-1]
    tl, tm = torch.from_numpy(logits), torch.from_numpy(masks)
    jl, jm = jnp.asarray(logits), jnp.asarray(masks)
    pairs = []
    for dw in (1.0, 0.5, 0.0):
        pairs.append((compute_loss(tl, tm, nc, dice_weight=dw),
                      j_compute_loss(jl, jm, nc, dice_weight=dw)))
    if nc == 1:
        prob = torch.sigmoid(tl[..., 0])
        jprob = jax.nn.sigmoid(jl[..., 0])
        mf, jmf = tm.float(), jm.astype(jnp.float32)
        pairs += [(bce_with_logits(tl[..., 0], mf), j_bce(jl[..., 0], jmf)),
                  (dice_coeff(prob, mf), j_dice_coeff(jprob, jmf)),
                  (dice_coeff(prob[0], mf[0]), j_dice_coeff(jprob[0], jmf[0])),
                  (dice_loss(prob, mf), j_dice_loss(jprob, jmf)),
                  (iou_coeff(prob, mf), j_iou(jprob, jmf))]
        if case == "empty":
            assert abs(dice_coeff(mf, mf).item() - 1.0) < 1e-6
    else:
        prob = torch.softmax(tl, -1)
        oh = torch.nn.functional.one_hot(tm, nc).float()
        jprob, joh = jax.nn.softmax(jl, -1), jax.nn.one_hot(jm, nc)
        pairs += [(cross_entropy(tl, tm), j_ce(jl, jm)),
                  (dice_loss(prob, oh, multiclass=True), j_dice_loss(jprob, joh, multiclass=True)),
                  (iou_coeff(prob, oh), j_iou(jprob, joh))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.item(), float(ref), atol=1e-6, rtol=1e-6)


def _grad_tree(rng, params):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.05).astype(np.float32),
                        _numpy(params))


def test_rmsprop_and_clip_match_jax(rng):
    params, _ = j_init_unet(jax.random.PRNGKey(1), JConfig(3, 1, False, 4))
    jp, jo = params, j_rms_init(params)
    tp, to = tree_from_numpy(_numpy(params)), rmsprop_init(tree_from_numpy(_numpy(params)))
    for step in range(3):
        grads = _grad_tree(rng, params)
        jg, jn = j_clip(jax.tree.map(jnp.asarray, grads), 1.0)
        tg, tn = clip_grad_norm(tree_from_numpy(grads), 1.0)
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        assert float(jn) > 1.0  # the clip is active
        _assert_trees(tg, jg, atol=1e-7, rtol=1e-6)
        # identical (JAX-clipped) gradients into both optimizers
        jp, jo = j_rms_update(jg, jo, jp, LR * (step + 1), weight_decay=1e-8, momentum=0.999)
        tp, to = rmsprop_update(tree_from_numpy(_numpy(jg)), to, tp, LR * (step + 1),
                                weight_decay=1e-8, momentum=0.999)
        _assert_trees(tp, jp, atol=1e-5, rtol=1e-5)
        _assert_trees(to, jo, atol=1e-5, rtol=1e-5)


def test_rmsprop_matches_torch_optim(rng):
    shapes = [(3, 3, 4, 8), (8,), (1, 1, 8, 2)]
    values = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ref = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in values]
    opt = torch.optim.RMSprop(ref, lr=LR, alpha=0.99, eps=1e-8, weight_decay=1e-8,
                              momentum=0.999)
    params = {f"p{i}": torch.from_numpy(v.copy()) for i, v in enumerate(values)}
    state = rmsprop_init(params)
    for _ in range(5):
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        opt.step()
        params, state = rmsprop_update({f"p{i}": g for i, g in enumerate(grads)}, state, params,
                                       LR, weight_decay=1e-8, momentum=0.999)
    for i, p in enumerate(ref):
        torch.testing.assert_close(params[f"p{i}"], p.detach(), atol=1e-6, rtol=1e-5)


def _model(bilinear, seed=0, n_classes=1):
    jcfg = JConfig(3, n_classes, bilinear, BASE)
    params, state = j_init_unet(jax.random.PRNGKey(seed), jcfg)
    return jcfg, UNetConfig(*jcfg), _numpy(params), _numpy(state)


@pytest.mark.parametrize("bilinear", [False, True])
def test_unet_apply_matches_jax(bilinear):
    jcfg, cfg, params, state = _model(bilinear)
    x, _ = j_synth_batch(np.random.default_rng(3), B, H, W)
    tp, ts = tree_from_numpy(params), tree_from_numpy(state)
    for train in (True, False):
        jy, jnew = j_apply(_copy(params), _copy(state), jnp.asarray(x), config=jcfg, train=train)
        ty, tnew = unet_apply(tp, ts, torch.from_numpy(x), config=cfg, train=train)
        assert ty.shape == (B, H, W, 1) and ty.dtype == torch.float32
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4, rtol=1e-4)
        _assert_trees(tnew, jnew, atol=1e-4, rtol=1e-4)
        if not train:
            _assert_trees(tnew, state)


def _run_steps(jstep, tstep, params, state, x, m, n):
    """n steps of both; returns the per-step (jax, port) outputs."""
    jtrees = (params, state, _numpy(j_rms_init(params)))
    ttrees = tuple(tree_from_numpy(t) for t in jtrees)
    outs = []
    for _ in range(n):
        jo = jstep(*(_copy(t) for t in jtrees), jnp.asarray(x), jnp.asarray(m), jnp.float32(LR))
        to = tstep(*ttrees, torch.from_numpy(x), torch.from_numpy(m), LR)
        jtrees, ttrees = tuple(_numpy(t) for t in jo[:3]), to[:3]
        outs.append((jo, to))
    return outs


def _check_step(jo, to):
    np.testing.assert_allclose(float(to[3]), float(jo[3]), rtol=1e-5)
    np.testing.assert_allclose(float(to[4]), float(jo[4]), rtol=1e-4)
    _assert_trees(to[5], jo[5], atol=1e-6, scale=1e-3)          # clipped gradients
    _assert_trees(to[1], jo[1], atol=1e-4, rtol=1e-4)           # BN running stats
    _assert_trees(to[2].square_avg, jo[2].square_avg, atol=1e-9, rtol=1e-3)
    _assert_trees(to[0], jo[0], atol=2e-2)                      # params after RMSprop


@pytest.mark.parametrize("kernels,jkernels", [(None, None), ("cuda", "pallas")])
def test_train_step_matches_jax(kernels, jkernels):
    """One step in full and a 3-step loss history; kernels="cuda" routes
    every DoubleConv through ConvStatsRaw/ConvStatsPro (plain versions on
    this CPU), against JAX's Pallas kernels in interpret mode."""
    jcfg, cfg, params, state = _model(False)
    x, m = j_synth_batch(np.random.default_rng(5), B, H, W)
    jstep = j_make_step(jcfg, return_grads=True, kernels=jkernels)
    tstep = make_train_step(cfg, return_grads=True, kernels=kernels)
    K.reset_launch_counts()
    outs = _run_steps(jstep, tstep, params, state, x, m, 3)
    assert all(n == 0 for n in K.launch_counts().values())  # CPU: plain versions
    _check_step(*outs[0])
    losses = [(float(t[3]), float(j[3])) for j, t in outs]
    np.testing.assert_allclose([t for t, _ in losses], [j for _, j in losses], rtol=1e-4)
    assert losses[2][0] < losses[0][0]


def test_train_step_accum_matches_jax():
    """accum_steps=2: microbatch j takes rows j::2, BN stats per microbatch,
    gradients and loss averaged; a batch 2 does not divide runs plainly.

    At 40x36 rather than 33x20: a microbatch of 2 at 33x20 leaves down4's BN
    4 values per channel, where fp32 rounding alone moves the gradients by
    0.4% (JAX's own scan and unrolled steps differ by that much); at 40x36
    (still odd at 5 and 9 pixels, so the decoder pads) it has 8, and the two
    JAX steps agree to 2e-5."""
    jcfg, cfg, params, state = _model(True, seed=2)
    x, m = j_synth_batch(np.random.default_rng(6), 4, 40, 36)
    jstep = j_make_step(jcfg, return_grads=True, accum_steps=2)
    tstep = make_train_step(cfg, return_grads=True, accum_steps=2)
    (jo, to), = _run_steps(jstep, tstep, params, state, x, m, 1)
    _check_step(jo, to)
    odd = make_train_step(cfg, accum_steps=3)  # 4 % 3: one unaccumulated step
    plain = make_train_step(cfg)
    ttrees = tuple(tree_from_numpy(t) for t in (params, state, _numpy(j_rms_init(params))))
    a = odd(*ttrees, torch.from_numpy(x), torch.from_numpy(m), LR)
    b = plain(*ttrees, torch.from_numpy(x), torch.from_numpy(m), LR)
    assert a[3].item() == b[3].item()


def test_make_train_step_refuses_what_is_not_ported():
    cfg = UNetConfig(3, 1, False, BASE)
    # Data parallelism and ZeRO are ported (mesh=, opt_shardings=;
    # tests/test_torch_data_parallel.py, test_torch_zero.py): ZeRO's
    # shardings need the mesh whose ranks hold them.
    for kwargs, err in [({"opt_shardings": {}}, ValueError),
                        ({"optimizer": "lbfgs"}, ValueError),
                        ({"nesterov": True}, ValueError),  # an SGD option, as in JAX
                        ({"vmem_limit_kib": 65536}, ValueError),
                        ({"kernels": "pallas"}, ValueError),
                        ({"accum_steps": 0}, ValueError)]:
        with pytest.raises(err):
            make_train_step(cfg, **kwargs)
    _, _, params, state = _model(False)
    x = torch.zeros(1, 8, 8, 3)
    # JAX's axis_name is the port's group (a ProcessGroup): a name is refused.
    with pytest.raises(TypeError, match="axis_name"):
        unet_apply(tree_from_numpy(params), tree_from_numpy(state), x, config=cfg,
                   axis_name="data")
    # The families have no kernel route, as JAX's have no kernels="pallas".
    with pytest.raises(ValueError, match="arch='unetpp'"):
        unet_apply({}, {}, x, config=cfg._replace(arch="unetpp"), kernels="cuda")
