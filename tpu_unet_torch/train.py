"""The train step (``tpu_unet/train.py``: ``compute_loss``,
``make_train_step``).

One step is forward, the reference's criterion, backward, global-norm
clipping and RMSprop, over the port's dict-of-tensors params:

    step(params, bn_state, opt_state, images, masks, lr)
      -> (params, bn_state, opt_state, loss, grad_norm[, grads])

It returns new trees and updates nothing in place, as the JAX step does.
``kernels="cuda"`` runs every DoubleConv on the hand-written train kernels
(``ops/conv_stats.py``), the counterpart of JAX's ``kernels="pallas"``;
``kernels=None`` runs library convs and ``ops.batch_norm`` under autograd.
``amp`` is the JAX package's bf16 compute (no loss scaling: bf16 keeps
fp32's exponent range). The train loop, CLI, evaluation and data loader are
not ported yet.
"""

from __future__ import annotations

import torch

from tpu_unet_torch.losses import bce_with_logits, cross_entropy, dice_loss
from tpu_unet_torch.models.unet import UNetConfig, tree_leaves, tree_map, unet_apply
from tpu_unet_torch.optim import clip_grad_norm, rmsprop_update


def compute_loss(logits: torch.Tensor, masks: torch.Tensor, n_classes: int,
                 dice_weight: float = 1.0) -> torch.Tensor:
    """The reference's criterion: BCE-with-logits + binary Dice on the
    squeezed channel (one class), else cross-entropy + multiclass Dice over
    the softmax. ``dice_weight`` scales the Dice term; 0 drops it."""
    if n_classes == 1:
        logit = logits[..., 0]
        mask_f = masks.float()
        ce = bce_with_logits(logit, mask_f)
        dl = dice_loss(torch.sigmoid(logit), mask_f) if dice_weight else None
    else:
        mask_oh = torch.nn.functional.one_hot(masks.long(), n_classes).float()
        ce = cross_entropy(logits, masks)
        dl = (dice_loss(torch.softmax(logits, dim=-1), mask_oh, multiclass=True)
              if dice_weight else None)
    return ce if dl is None else ce + dice_weight * dl


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_train_step(config: UNetConfig, *, amp: bool = False, remat: bool = False,
                    weight_decay: float = 1e-8, momentum: float | None = None,
                    grad_clip: float = 1.0, return_grads: bool = False,
                    kernels: str | None = None, mesh=None, accum_steps: int = 1,
                    vmem_limit_kib: int | None = None, opt_shardings=None,
                    optimizer: str = "rmsprop", nesterov: bool = False,
                    dice_weight: float = 1.0):
    """Build the train step. The arguments are the JAX ``make_train_step``'s;
    what the port does not have yet is refused, not ignored: ``remat``,
    ``mesh``, ``opt_shardings``, ``vmem_limit_kib`` (TPU-only), ``nesterov``
    and any optimizer but the reference's RMSprop (``momentum`` None takes
    its 0.999).

    ``return_grads`` appends the clipped gradients. ``accum_steps`` > 1 runs
    the batch as that many microbatches, microbatch j taking rows ``j::A``,
    with BN statistics per microbatch (the running stats thread through in
    order) and the gradients and loss averaged; a batch that ``accum_steps``
    does not divide runs unaccumulated."""
    if remat:
        raise NotImplementedError("make_train_step: remat is not ported yet")
    if mesh is not None or opt_shardings is not None:
        raise NotImplementedError("make_train_step: data parallelism (mesh, opt_shardings) "
                                  "is not ported yet")
    if vmem_limit_kib is not None:
        raise ValueError("make_train_step: vmem_limit_kib is a TPU compiler option")
    if optimizer != "rmsprop" or nesterov:
        raise NotImplementedError(f"make_train_step: only the reference RMSprop is ported, "
                                  f"not {optimizer!r} (nesterov={nesterov})")
    if kernels not in (None, "cuda"):
        raise ValueError(f"kernels must be None or 'cuda', got {kernels!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    compute_dtype = torch.bfloat16 if amp else None
    mom = 0.999 if momentum is None else momentum

    def grads_and_loss(params, bn_state, images, masks):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        logits, new_bn = unet_apply(_unflatten(params, leaves), bn_state, images, config=config,
                                    train=True, compute_dtype=compute_dtype, kernels=kernels)
        loss = compute_loss(logits, masks, config.n_classes, dice_weight=dice_weight)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), new_bn, _unflatten(params, grads)

    def step(params, bn_state, opt_state, images, masks, lr):
        n = images.shape[0]
        if accum_steps == 1 or n % accum_steps:
            loss, new_bn, grads = grads_and_loss(params, bn_state, images, masks)
        else:
            new_bn, gsum, lsum = bn_state, None, 0.0
            for j in range(accum_steps):
                loss_j, new_bn, g = grads_and_loss(params, new_bn, images[j::accum_steps],
                                                   masks[j::accum_steps])
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                lsum = lsum + loss_j
            inv = 1.0 / accum_steps
            grads = tree_map(lambda g: g * inv, gsum)
            loss = lsum * inv
        grads, gnorm = clip_grad_norm(grads, grad_clip)
        new_params, new_opt = rmsprop_update(grads, opt_state, params, lr,
                                             weight_decay=weight_decay, momentum=mom)
        out = (new_params, new_bn, new_opt, loss, gnorm)
        return out + (grads,) if return_grads else out

    return step
