"""W&B and loss-history logging for the train loop
(``tpu_unet/train_logging.py``).

The reference's W&B surface: ``wandb.init(project="U-Net", resume="allow",
anonymous="must")`` with the run's config; per step the train loss, step
and epoch; at each validation the learning rate, val Dice and IoU, the
sample triplet (image, true mask, predicted mask) and weight and gradient
histograms. ``wandb`` is optional (offline by default): without it the run
warns and trains on.

- Per-step losses stay on the device and cross to the host in one fetch at
  each validation and epoch end (``LossDrain``): a ``float(loss)`` per step
  would wait for the card every step. The per-step W&B logs ride that fetch.
- Histograms subsample each leaf on the device (``_subsample_leaf``) and
  fetch every leaf's sample in one copy. Gradients are recomputed at the
  current params on the last full train batch with the library-conv route,
  as the JAX package's ``hist_sample_step`` does.
- Under data parallelism that gradient pass is the global batch's (BN and
  the loss over ``group``, the gradients averaged over the ranks), so every
  rank runs it and rank 0 alone logs. When the world spans hosts the panel
  logs the scalars only and no rank runs the gradient pass, as the JAX
  package's does under ``--multihost``. On a (data x spatial) grid the
  gradient pass runs over the grid (``group`` the ``Grid``), and the sample
  triplet is the whole first image, its bands gathered over rank 0's
  spatial group (JAX's is a global array); the logging rank runs its eval
  forward alone. Under tensor parallelism (``full``) every rank gathers
  the weights, BN state and gradients over its model group, so the
  histograms and the sample are the whole model's.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

import torch.distributed as dist

from tpu_unet_torch.models.unet import tree_leaves, unet_apply
from tpu_unet_torch.parallel.mesh import pmean, world_of

logger = logging.getLogger(__name__)

_HIST_CAP = 16384  # elements of a leaf above which its histogram is subsampled


def _subsample_leaf(leaf: torch.Tensor) -> torch.Tensor:
    """A strided sample of the flattened leaf, on its device: every
    ``numel // _HIST_CAP``-th element, so at most 2·_HIST_CAP of them."""
    flat = leaf.detach().reshape(-1)
    return flat[::max(1, flat.numel() // _HIST_CAP)]


def _keyed_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key path, tensor) of each leaf, the path joined with "/" as the JAX
    package names its histograms (dict keys and NamedTuple fields)."""
    if isinstance(tree, tuple):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _keyed_leaves(v, f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def init_wandb(use_wandb: bool, run_config: dict):
    """One W&B run for the job, offline unless ``WANDB_MODE`` says
    otherwise. None when not asked for or when wandb cannot start (a
    warning, and training goes on)."""
    if not use_wandb:
        return None
    try:
        import wandb

        os.environ.setdefault("WANDB_MODE", "offline")
        experiment = wandb.init(project="U-Net", resume="allow", anonymous="must")
        experiment.config.update(run_config)
        return experiment
    except Exception as e:  # wandb is optional: any failure to start it is logged
        logger.warning("wandb unavailable (%s); continuing without it", e)
        return None


class LossDrain:
    """Per-step device losses, fetched to ``history["train_loss"]`` in one
    copy by ``drain()``, which also sends each step's W&B log."""

    def __init__(self, history: dict, experiment=None):
        self.history = history
        self.experiment = experiment
        self._losses: list[torch.Tensor] = []
        self._meta: list[tuple[int, int]] = []

    def append(self, loss: torch.Tensor, step: int, epoch: int) -> None:
        self._losses.append(loss.detach())
        self._meta.append((step, epoch))

    def drain(self) -> None:
        if not self._losses:
            return
        vals = torch.stack(self._losses).float().cpu().tolist()
        self.history["train_loss"].extend(vals)
        if self.experiment:
            for (s, ep), v in zip(self._meta, vals):
                self.experiment.log({"train loss": v, "step": s, "epoch": ep})
        self._losses.clear()
        self._meta.clear()


class WandbValidationPanel:
    """The W&B log of one validation: the scalars, the sample triplet from
    the eval forward and the subsampled weight and gradient histograms.

    Under data parallelism (``group``) ``enabled`` says whether rank 0 logs:
    then every rank takes part in the gradient pass, and only the rank with
    the ``experiment`` logs. ``multihost``: the scalars only, no gradient
    pass on any rank. ``full`` (tensor parallelism) maps (params, BN state,
    gradients) of this rank's shards to the whole trees, on every rank."""

    def __init__(self, experiment, *, config, amp: bool, remat: bool, dice_weight: float,
                 accum_steps: int, group=None, enabled: bool | None = None,
                 multihost: bool = False, full=None):
        self.experiment = experiment
        self.full = full
        self.multihost = multihost
        self.group = group
        self.enabled = experiment is not None if enabled is None else enabled
        self.config = config
        self.compute_dtype = torch.bfloat16 if amp else None
        self.remat = remat
        self.dice_weight = dice_weight
        self.accum_steps = accum_steps

    def _hist_sample(self, params, bn_state, images, masks):
        """(weights, gradients) as [(key, subsampled leaf)], the gradients
        of the loss at ``params`` on this batch (library convs, the new BN
        state dropped), and the whole (params, BN state)."""
        from tpu_unet_torch.train import _unflatten, compute_loss  # train.py imports this module

        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        logits, _ = unet_apply(_unflatten(params, leaves), bn_state, images, config=self.config,
                               train=True, compute_dtype=self.compute_dtype, remat=self.remat,
                               group=self.group)
        loss = compute_loss(logits, masks, self.config.n_classes, dice_weight=self.dice_weight,
                            group=self.group)
        grads = torch.autograd.grad(loss, leaves)
        if self.group is not None:
            grads = pmean(list(grads), world_of(self.group))
        if self.full is not None:
            params, bn_state, tree = self.full(params, bn_state, _unflatten(params, grads))
            grads = tree_leaves(tree)
        keyed = _keyed_leaves(params)
        return ([(k, _subsample_leaf(p)) for k, p in keyed],
                [(k, _subsample_leaf(g)) for (k, _), g in zip(keyed, grads)], params, bn_state)

    def log(self, *, lr_now, val_dice, val_iou, step: int, epoch: int, params, bn_state,
            images, masks, hist_batch) -> None:
        if not self.enabled:
            return
        scalars = {"learning rate": lr_now, "validation Dice": val_dice,
                   "validation IoU": val_iou, "step": step, "epoch": epoch}
        if self.multihost:
            if self.experiment is not None:
                self.experiment.log(scalars)
            return
        h_imgs, h_masks = hist_batch if hist_batch else (images, masks)
        if self.accum_steps > 1:
            # The train step ran this batch as microbatches: keep the
            # histogram pass's activations to one microbatch's too.
            mb = max(1, h_imgs.shape[0] // self.accum_steps)
            h_imgs, h_masks = h_imgs[:mb], h_masks[:mb]
        w_sub, g_sub, params, bn_state = self._hist_sample(params, bn_state, h_imgs, h_masks)
        image, mask = images[0], masks[0]
        if getattr(self.group, "spatial_size", 1) > 1:
            image, mask = (_whole(t, self.group.spatial_group) for t in (image, mask))
        if self.experiment is None:
            return  # a data-parallel rank that does not log
        import wandb

        # One copy to the host for every sample.
        subs = [t for _, t in w_sub + g_sub]
        host = torch.cat([t.float() for t in subs]).cpu().numpy()
        parts = np.split(host, np.cumsum([t.numel() for t in subs])[:-1])

        def histograms(keyed, values, prefix):
            return {prefix + k: wandb.Histogram(v) for (k, _), v in zip(keyed, values)
                    if np.all(np.isfinite(v))}  # the reference skips inf/nan

        with torch.no_grad():
            lg, _ = unet_apply(params, bn_state, image[None], config=self.config, train=False,
                               compute_dtype=self.compute_dtype)
            if self.config.n_classes > 1:
                pred0 = lg[0].argmax(dim=-1)
            else:
                pred0 = torch.sigmoid(lg[0, ..., 0]) > 0.5
        self.experiment.log({
            **scalars,
            "images": wandb.Image(image.float().cpu().numpy()),  # HWC, as the JAX package
            "masks": {
                "true": wandb.Image(mask.cpu().numpy().astype(np.float32)),
                "pred": wandb.Image(pred0.cpu().numpy().astype(np.float32)),
            },
            **histograms(w_sub, parts[:len(w_sub)], "Weights/"),
            **histograms(g_sub, parts[len(w_sub):], "Gradients/"),
        })


def _whole(band: torch.Tensor, group) -> torch.Tensor:
    """An image [h, ...] whole again from its height bands on the ranks of
    ``group`` (a collective), in its dtype."""
    parts = [torch.empty_like(band, dtype=torch.float32) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, band.float().contiguous(), group=group)
    return torch.cat(parts).to(band.dtype)
