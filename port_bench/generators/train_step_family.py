"""Traffic kind ``train_step_family``: ``generators/train_step.py``'s closed
loop, step for step, for a model family that ``reference.py`` does not hold
(``families/<arch>.py``, by the configuration's ``model.arch``).

Set-up draws the weights and BN statistics from the seed by the family's
layout, builds the program's step (``make_train_step``) for the program's
``UNetConfig`` with the configuration's ``recur_t`` and ``recur_bn``, runs
``check_steps`` steps through the window's own call and feed (their losses,
first gradients and changes, and the first step's running statistics, are
read for the check), then ``warmup_steps``
more, then the window; after the window the program is freed and the
family's plain reference steps the same weights through the same batches.
The numbers compared are ``check.train_numbers``' and the first step's
(``families.first_step_numbers``); the readings are a ``train`` run's, so
the generic readers apply.

Traffic parameters: ``amp`` (bf16 compute), ``batch``, ``pool_batches``,
``check_steps``, ``warmup_steps``.
"""

from __future__ import annotations

import time

import torch

from port_bench import check, families, inputs, reference
from port_bench.program import leaves_by_path, model_config, train_size, trees_for


def program_config(cfg: dict):
    """The program's ``UNetConfig`` of a family's configuration file,
    ``recur_t`` and ``recur_bn`` included."""
    m = cfg["model"]
    return model_config(cfg)._replace(recur_t=m["recur_t"], recur_bn=m["recur_bn"])


def setup(cfg: dict, tr: dict, seed: int, dev, kernels):
    """The weights and pool drawn from ``seed``, and the program's step and
    trees (params, BN state, RMSprop state) holding those weights:
    (weights, images, masks, step, trees)."""
    from tpu_unet_torch.ops.conv import full_fp32
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    fam = families.module(cfg["model"]["arch"])
    rec = cfg["recipe"]
    if dev.type == "cuda":
        full_fp32()  # the train CLI's device set-up: fp32 means fp32, no TF32
    h, w = train_size(cfg)
    g = inputs.generator(seed, dev)
    weights = fam.make_weights(cfg["model"], g, dev)
    bn0 = fam.initial_bn_state(cfg["model"], dev)
    images, masks = inputs.train_pool(g, tr["pool_batches"], tr["batch"], h, w, dev)
    mcfg = program_config(cfg)
    params, state = trees_for(mcfg, weights, bn0)
    step = make_train_step(mcfg, amp=tr["amp"], kernels=kernels,
                           weight_decay=rec["weight_decay"], momentum=rec["momentum"],
                           grad_clip=rec["grad_clip"])
    return weights, images, masks, step, (params, state, rmsprop_init(params))


def check_steps(one, trees, n: int, weights: dict):
    """``n`` steps through ``one``; (trees, the program's readings of them:
    losses, first gradients' norms and square averages (on the host),
    the first step's running statistics, each leaf's change)."""
    losses = []
    for i in range(n):
        trees, loss = one(i, trees)
        losses.append(loss)
        if i == 0:
            sq = leaves_by_path(trees[2].square_avg)
            grad = dict(zip(sq, reference.grad_norms(sq.values())))
            sq1 = {k: v.float().to("cpu", copy=True) for k, v in sq.items()}
            bn1 = families.state_by_path(trees[1])
            del sq
    p_now = leaves_by_path(trees[0])
    change = dict(zip(p_now, reference.norms([p_now[k] - weights[k] for k in p_now])))
    return trees, {"loss": [float(x) for x in losses], "grad": grad, "change": change,
                   "bn1": bn1, "sq1": sq1}


def run(ctx) -> dict:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    fam = families.module(cfg["model"]["arch"])
    weights, images, masks, step, trees = setup(cfg, tr, ctx.seed, dev, ctx.kernels("train"))
    h, w = train_size(cfg)
    nb, lr = len(images), cfg["recipe"]["lr"]

    def one(i, trees):  # the window's call and feed
        out = step(*trees, images[i % nb], masks[i % nb], lr)
        return out[:3], out[3]

    with ctx.spans.span("setup.check_steps"):
        trees, prog = check_steps(one, trees, tr["check_steps"], weights)
        weights_host = {k: v.cpu() for k, v in weights.items()}
        del weights
    with ctx.spans.span("setup.warmup_steps"):
        for i in range(tr["check_steps"], tr["check_steps"] + tr["warmup_steps"]):
            trees, _ = one(i, trees)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    i, steps = tr["check_steps"] + tr["warmup_steps"], 0
    with ctx.window() as win:
        t_end = win.t0 + ctx.seconds
        while True:
            with ctx.spans.span("train.step"):
                trees, _ = one(i, trees)
            i += 1
            steps += 1
            if time.perf_counter() >= t_end:
                break
    del trees, step
    batches = list(zip(images, masks))[: tr["check_steps"]]
    del images, masks
    ctx.free()

    t_ref = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with reference.precision(tf32=False):
        ref = fam.train_steps(cfg["model"], {k: v.to(dev) for k, v in weights_host.items()},
                              fam.initial_bn_state(cfg["model"], dev), batches, lr=lr)
    t_steps = time.perf_counter() - t_ref
    ref_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    judged = check.train_numbers(prog, ref)
    numbers = {**judged["numbers"], **families.first_step_numbers(
        prog, ref, fam.initial_bn_state(cfg["model"], dev))}
    return {
        "attempted": steps, "failed": 0,
        "end_to_end": {"train_img_s": steps * tr["batch"] / win.seconds},
        "numbers": numbers,
        "diagnostics": {"numbers": numbers, "worst_leaf": judged["worst"],
                        "quiet_leaves": judged["quiet_leaves"],
                        "reference_s": time.perf_counter() - t_ref,
                        "reference_step_s": ref["step_s"], "reference_call_s": t_steps,
                        "reference_peak_gib": ref_peak / float(1 << 30)},
        "readings": {"kind": "train", "steps": steps, "images": steps * tr["batch"],
                     "window_s": win.seconds, "height": h, "width": w},
    }
