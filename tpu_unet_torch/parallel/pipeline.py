"""Pipeline parallelism (GPipe) for the flagship U-Net
(``tpu_unet/parallel/pipeline.py``).

The block chain is split into S contiguous stages; stage s's params, BN
state and fp32 RMSprop trees live on device s alone, microbatches stream
through the stages, and only the boundary payloads cross between devices.
One process drives every stage: each payload moves with
``.to(devices[s + 1], non_blocking=True)``, so CUDA's asynchronous launches
let stage s of microbatch j run beside stage s - 1 of microbatch j + 1, as
JAX's asynchronous dispatch does. No collective is written by hand.

- **Segments.** The U-Net is a linear chain of segments over a payload
  dict (``SEGMENT_NAMES``). A skip made in an encoder stage rides the
  payload until its decoder reader, the last, drops it, so a boundary moves
  exactly the live set.
- **Schedule.** The forward wave runs every microbatch through stages
  0..S-2 without autograd, keeps only each stage's input payload, and
  threads the BN running statistics in order. The backward wave runs the
  last stage's forward and backward together, then recomputes each earlier
  stage under autograd from its stored input (GPipe's recompute) and
  discards the statistics of that second forward. The gradients are then
  averaged, clipped once by the norm over every stage, and each stage is
  updated by RMSprop on its device.

One step with M microbatches is ``train.make_train_step(accum_steps=M)``'s:
microbatch j is rows ``j::M`` (a batch that M does not divide runs as one
microbatch), BN statistics per microbatch, loss and gradients averaged, one
clip, one update; it matches to round-off.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any

import torch

from tpu_unet_torch.models.unet import (
    UNetConfig,
    _double_conv_apply,
    _up_apply,
    tree_leaves,
    tree_map,
)
from tpu_unet_torch.ops import conv2d, max_pool2d
from tpu_unet_torch.optim import RMSpropState, clip_to_norm, rmsprop_init, rmsprop_update


def _seg_inc(p, s, pl, cfg):
    h, ns = _double_conv_apply(p, s, pl["x"], train=True, first=True)
    return {"x1": h}, ns


def _make_seg_down(i: int):
    def seg(p, s, pl, cfg):
        h, ns = _double_conv_apply(p, s, max_pool2d(pl[f"x{i}"]), train=True)
        return {**pl, f"x{i + 1}": h}, ns

    return seg


def _make_seg_up(i: int):
    # up_i reads the working activation and skip x_{5-i}, both dead after it.
    skip_key = f"x{5 - i}"
    cur_key = "x5" if i == 1 else "h"

    def seg(p, s, pl, cfg):
        block = functools.partial(_double_conv_apply, train=True)
        h, ns = _up_apply(p, s, pl[cur_key], pl[skip_key], bilinear=cfg.bilinear, block=block)
        out = {k: v for k, v in pl.items() if k not in (cur_key, skip_key)}
        out["h"] = h
        return out, ns

    return seg


def _seg_outc(p, s, pl, cfg):
    logits = conv2d(pl["h"], p["w"], stride=1, padding=0)
    return {"logits": logits.float() + p["b"].float()}, None


_SEGMENTS: list[tuple[str, Any]] = [
    ("inc", _seg_inc),
    *[(f"down{i}", _make_seg_down(i)) for i in range(1, 5)],
    *[(f"up{i}", _make_seg_up(i)) for i in range(1, 5)],
    ("outc", _seg_outc),
]
SEGMENT_NAMES = [name for name, _ in _SEGMENTS]
_SEGMENT_FN = dict(_SEGMENTS)

# The JAX package's relative weights per segment for stage balancing
# (``tpu_unet/parallel/pipeline.py::_SEGMENT_WEIGHT``, from its own
# per-level profile), copied as they stand. Balancing moves only speed,
# never results.
_SEGMENT_WEIGHT = {
    "inc": 20, "down1": 6, "down2": 6, "down3": 5, "down4": 5,
    "up1": 9, "up2": 9, "up3": 10, "up4": 29, "outc": 1,
}


def split_stages(n_stages: int) -> list[list[str]]:
    """The contiguous partition of the segments into ``n_stages`` stages
    that minimises the heaviest stage's weight (the first such, in
    ``itertools.combinations`` order, as JAX's)."""
    n_seg = len(SEGMENT_NAMES)
    if not 2 <= n_stages <= n_seg:
        raise ValueError(f"n_stages must be in [2, {n_seg}], got {n_stages}")
    weights = [_SEGMENT_WEIGHT[n] for n in SEGMENT_NAMES]
    best, best_cost = None, float("inf")
    for cuts in itertools.combinations(range(1, n_seg), n_stages - 1):
        bounds = (0, *cuts, n_seg)
        cost = max(sum(weights[a:b]) for a, b in zip(bounds, bounds[1:]))
        if cost < best_cost:
            best, best_cost = bounds, cost
    return [SEGMENT_NAMES[a:b] for a, b in zip(best, best[1:])]


def _stage_forward(params_s, state_s, payload, *, seg_names, config, compute_dtype):
    """One stage's segments in order: (payload out, new BN state). Under amp
    the stage casts its params, and the first casts the image, as
    ``unet_apply`` does."""
    if compute_dtype is not None:
        params_s = tree_map(lambda p: p.to(compute_dtype), params_s)
        if "inc" in seg_names:
            payload = {**payload, "x": payload["x"].to(compute_dtype).contiguous()}
    new_state = {}
    for name in seg_names:
        payload, ns = _SEGMENT_FN[name](params_s.get(name), state_s.get(name), payload, config)
        if ns is not None:
            new_state[name] = ns
    return payload, new_state


def _put(tree, device):
    return tree_map(lambda t: t.to(device, non_blocking=True), tree)


def default_devices() -> list[torch.device]:
    """``cuda:0`` .. ``cuda:N-1``, the cards of this host (none without CUDA)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device(f"cuda:{i}") for i in range(n)]


class PipelineRunner:
    """The stage-placed GPipe train step of the flagship U-Net (module
    docstring). Holds each stage's (params, BN state, RMSprop state) on its
    device; ``step`` runs one optimizer step over a batch; ``gather``
    reassembles the full trees on the first stage's device. ``devices``
    (default ``default_devices()``) takes any list of devices, e.g. the CPU
    S times."""

    def __init__(self, params, bn_state, config: UNetConfig, *, n_stages: int,
                 microbatches: int, opt_state: RMSpropState | None = None, amp: bool = False,
                 weight_decay: float = 1e-8, momentum: float = 0.999, grad_clip: float = 1.0,
                 dice_weight: float = 1.0, devices: list | None = None):
        if config.arch != "unet":
            raise ValueError("pipeline parallelism is wired for the flagship U-Net's block "
                             f"chain only, not arch={config.arch!r}")
        if config.s2d_level0:
            raise ValueError("pipeline parallelism does not support the s2d_level0 "
                             "experiment path")
        if microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {microbatches}")
        devices = [torch.device(d) for d in (default_devices() if devices is None else devices)]
        if len(devices) < n_stages:
            raise ValueError(f"pipeline needs {n_stages} devices, have {len(devices)}")
        unknown = set(params) - set(SEGMENT_NAMES)
        if unknown:
            raise ValueError(f"unexpected param keys for pipeline: {unknown}")
        self.config = config
        self.microbatches = microbatches
        self.grad_clip = float(grad_clip)
        self.dice_weight = dice_weight
        self.n_stages = n_stages
        self.stages = split_stages(n_stages)
        self.devices = devices[:n_stages]
        self.compute_dtype = torch.bfloat16 if amp else None
        self._update = functools.partial(rmsprop_update, weight_decay=weight_decay,
                                         momentum=momentum)
        if opt_state is None:
            opt_state = rmsprop_init(params)
        self.params, self.state, self.opt = [], [], []
        for segs, dev in zip(self.stages, self.devices):
            self.params.append(_put({k: params[k] for k in segs if k in params}, dev))
            self.state.append(_put({k: bn_state[k] for k in segs if k in bn_state}, dev))
            self.opt.append(RMSpropState(
                _put({k: opt_state.square_avg[k] for k in segs if k in params}, dev),
                _put({k: opt_state.momentum_buf[k] for k in segs if k in params}, dev)))
        # Test and debug hook: with keep_grads set, step() keeps the clipped
        # gradients of each stage on its device (gather_grads()).
        self.keep_grads = False
        self._last_grads: list | None = None

    def _forward(self, s: int, params, payload):
        return _stage_forward(params, self.state[s], payload, seg_names=self.stages[s],
                              config=self.config, compute_dtype=self.compute_dtype)

    def _backward(self, s: int, payload, cot=None, masks=None):
        """Stage s's forward under autograd from its input ``payload`` and
        its backward: (parameter gradients, the input payload's cotangents,
        the new BN state, the loss). The last stage (``masks`` given) takes
        the loss's gradient; any other, ``cot`` on its output payload."""
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(self.params[s])]
        it = iter(leaves)
        params = tree_map(lambda _: next(it), self.params[s])
        ins = {k: v.detach().requires_grad_(True) for k, v in payload.items()
               if k != "x" and v.is_floating_point()}
        out, ns = self._forward(s, params, {**payload, **ins})
        if masks is not None:
            from tpu_unet_torch.train import compute_loss  # train.py imports this module

            loss = compute_loss(out["logits"], masks, self.config.n_classes,
                                dice_weight=self.dice_weight)
            outputs, grad_outputs = [loss], None
        else:
            loss = None
            outputs = [out[k] for k in cot]
            grad_outputs = [cot[k] for k in cot]
        grads = torch.autograd.grad(outputs, leaves + list(ins.values()), grad_outputs,
                                    allow_unused=True, materialize_grads=True)
        return (grads[:len(leaves)], dict(zip(ins, grads[len(leaves):])), ns,
                None if loss is None else loss.detach())

    def step(self, images, masks, lr):
        """One GPipe step over the batch: the forward wave, the backward wave,
        the clip, RMSprop. Returns (loss, grad norm) as device scalars; the
        host waits on nothing."""
        n = images.shape[0]
        m = self.microbatches if n % self.microbatches == 0 else 1
        S, dev = self.n_stages, self.devices
        # Forward wave: cache[j][s] is stage s's input payload for microbatch
        # j, the only thing a microbatch keeps (the backward recomputes).
        cache = [[None] * S for _ in range(m)]
        mb_masks = []
        with torch.no_grad():
            for j in range(m):
                pl = {"x": images[j::m].to(dev[0], non_blocking=True)}
                mb_masks.append(masks[j::m].to(dev[-1], non_blocking=True))
                for s in range(S - 1):
                    cache[j][s] = pl
                    pl, self.state[s] = self._forward(s, self.params[s], pl)
                    pl = _put(pl, dev[s + 1])
                cache[j][S - 1] = pl
        # Backward wave, summing each stage's gradients.
        gsum: list = [None] * S
        losses = []
        for j in range(m):
            gp, cot, self.state[-1], loss = self._backward(S - 1, cache[j][S - 1],
                                                           masks=mb_masks[j])
            losses.append(loss)
            gsum[-1] = list(gp) if gsum[-1] is None else [a + b for a, b in zip(gsum[-1], gp)]
            for s in range(S - 2, -1, -1):
                gp, cot, _, _ = self._backward(s, cache[j][s], _put(cot, dev[s]))
                gsum[s] = list(gp) if gsum[s] is None else [a + b for a, b in zip(gsum[s], gp)]
            cache[j] = None  # free this microbatch's payloads
        inv = 1.0 / m
        grads = [[g * inv for g in gs] for gs in gsum]
        sq = [sum((g.float() * g.float()).sum() for g in gs).to(dev[0]) for gs in grads]
        total = torch.sqrt(sum(sq))
        clipped = []
        for s in range(S):
            it = iter(grads[s])
            clipped.append(clip_to_norm(tree_map(lambda _: next(it), self.params[s]),
                                        total.to(dev[s], non_blocking=True), self.grad_clip))
        self._last_grads = clipped if self.keep_grads else None
        for s in range(S):
            self.params[s], self.opt[s] = self._update(clipped[s], self.opt[s], self.params[s],
                                                       lr)
        lsum = 0.0
        for loss in losses:
            lsum = lsum + loss.to(dev[0])
        return lsum * inv, total

    def gather(self):
        """The full (params, BN state, RMSprop state) on the first stage's
        device, in the U-Net's key order."""
        put = functools.partial(_put, device=self.devices[0])
        params = {k: put(v) for tree in self.params for k, v in tree.items()}
        state = {k: put(v) for tree in self.state for k, v in tree.items()}
        opt = RMSpropState(
            {k: put(v) for o in self.opt for k, v in o.square_avg.items()},
            {k: put(v) for o in self.opt for k, v in o.momentum_buf.items()})
        return params, state, opt

    def gather_grads(self):
        """The last step's clipped gradient tree (set ``keep_grads`` before
        it), on the first stage's device."""
        if self._last_grads is None:
            raise RuntimeError("set keep_grads=True before step()")
        return {k: _put(v, self.devices[0]) for tree in self._last_grads for k, v in tree.items()}
