"""Traffic kind ``train_step``: the port's train step
(``tpu_unet_torch.train.make_train_step``) on one device, closed loop,
steps dispatched back to back as ``train_model`` dispatches them.

Set-up builds one step with its params, BN state and RMSprop state from the
seed, and drives it through the window's own call and feed for
``check_steps`` steps on batches that all differ: the losses, the first
gradient (from RMSprop's square average) and the change of every leaf are
read there for the check, and the same trees go on through ``warmup_steps``
more and into the window. The feed cycles a pool of ``pool_batches``
batches on the device. The window ends with a ``synchronize()``.

Traffic parameters: ``amp`` (bf16 compute), ``batch``, ``pool_batches``,
``check_steps``, ``warmup_steps``. The configuration gives the model, the
image size (``image`` scaled by ``scale``), the recipe and the kernel route
(``kernels.train``).
"""

from __future__ import annotations

import time

import torch

from port_bench import check, inputs, reference
from port_bench.program import leaves_by_path, model_config, train_size, trees_for


def run(ctx) -> dict:
    from tpu_unet_torch.ops.conv import full_fp32
    from tpu_unet_torch.optim import rmsprop_init
    from tpu_unet_torch.train import make_train_step

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    rec = cfg["recipe"]
    if dev.type == "cuda":
        full_fp32()  # the train CLI's device set-up: fp32 means fp32, no TF32
    h, w = train_size(cfg)
    g = inputs.generator(ctx.seed, dev)
    weights = inputs.make_weights(cfg["model"], g, dev)
    bn0 = inputs.initial_bn_state(cfg["model"], dev)
    images, masks = inputs.train_pool(g, tr["pool_batches"], tr["batch"], h, w, dev)

    mcfg = model_config(cfg)
    params, state = trees_for(mcfg, weights, bn0)
    step = make_train_step(mcfg, amp=tr["amp"], kernels=ctx.kernels("train"),
                           weight_decay=rec["weight_decay"], momentum=rec["momentum"],
                           grad_clip=rec["grad_clip"])
    trees = (params, state, rmsprop_init(params))
    del params, state
    nb, lr = len(images), rec["lr"]

    def one(i, trees):  # the window's call and feed
        out = step(*trees, images[i % nb], masks[i % nb], lr)
        return out[:3], out[3]

    losses = []
    with ctx.spans.span("setup.check_steps"):
        for i in range(tr["check_steps"]):
            trees, loss = one(i, trees)
            losses.append(loss)
            if i == 0:
                sq = leaves_by_path(trees[2].square_avg)
                grad = dict(zip(sq, reference.grad_norms(sq.values())))
                del sq
        p_now = leaves_by_path(trees[0])
        change = dict(zip(p_now, reference.norms([p_now[k] - weights[k] for k in p_now])))
        prog = {"loss": [float(x) for x in losses], "grad": grad, "change": change}
        weights_host = {k: v.cpu() for k, v in weights.items()}
        del weights, p_now, losses
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
    with reference.precision(tf32=False):
        ref = reference.train_steps(cfg["model"], {k: v.to(dev) for k, v in weights_host.items()},
                                    inputs.initial_bn_state(cfg["model"], dev), batches, lr=lr)
    t_steps = time.perf_counter() - t_ref
    judged = check.train_numbers(prog, ref)
    return {
        "attempted": steps, "failed": 0,
        "end_to_end": {"train_img_s": steps * tr["batch"] / win.seconds},
        "numbers": judged["numbers"],
        "diagnostics": {"numbers": judged["numbers"], "worst_leaf": judged["worst"],
                        "quiet_leaves": judged["quiet_leaves"],
                        "reference_s": time.perf_counter() - t_ref,
                        "reference_step_s": ref["step_s"], "reference_call_s": t_steps},
        "readings": {"kind": "train", "steps": steps, "images": steps * tr["batch"],
                     "window_s": win.seconds, "height": h, "width": w},
    }
