"""The train step (``tpu_unet/train.py``: ``compute_loss``,
``make_train_step``).

One step is forward, the reference's criterion, backward, global-norm
clipping and the optimizer update (RMSprop, the reference's, or
SGD/Adam/AdamW), over the port's dict-of-tensors params:

    step(params, bn_state, opt_state, images, masks, lr)
      -> (params, bn_state, opt_state, loss, grad_norm[, grads])

It returns new trees and updates nothing in place, as the JAX step does.
``kernels="cuda"`` runs every DoubleConv on the hand-written train kernels
(``ops/conv_stats.py``), the counterpart of JAX's ``kernels="pallas"``;
``kernels=None`` runs library convs and ``ops.batch_norm`` under autograd.
``amp`` is the JAX package's bf16 compute (no loss scaling: bf16 keeps
fp32's exponent range).

``train_model`` is the loop over the step (``tpu_unet/train.py``): a
seeded train/val split, the feed (the threaded loader with device prefetch;
the raw loader with the resize on the device, ``device_preprocess``; or the
corpus staged on the device, ``device_dataset``), augmentation on the
device, validation ``val_per_epoch`` times an epoch, the LR schedule, early
stopping, EMA and the checkpoint policy. Its CLI is ``train_cli.py``.

Data parallelism (``data_parallel``, ``parallel/mesh.py``) runs one
process per GPU, each with the same trees (broadcast from rank 0) and its
rows of each global batch, and the step's collectives make every rank's
result the global batch's. What the loop does once it does on every rank
in step or on rank 0 alone: every rank validates (the evaluation is
collective, so the schedule, EMA and early stopping decide alike); rank 0
alone writes checkpoints, the loss log and W&B, and the ranks meet at a
barrier before returning; a stop signal on any rank stops every rank at
the same batch (one host-side all-reduced flag a step). With ``zero``
(ZeRO-1, ``parallel/zero.py``) each rank holds 1/W of the optimizer state
and every rank gathers it whole before rank 0 writes a checkpoint. A world
that spans hosts (``parallel/multihost.py``) loads each process's rows of
each global batch, keeps whole val batches only, and logs W&B scalars
only.
Spatial, tensor and pipeline parallelism are not ported.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from tpu_unet_torch import train_ema
from tpu_unet_torch.checkpoint import load_checkpoint, read_checkpoint_meta
from tpu_unet_torch.data import DataLoader, prefetch_to_device, random_split_indices
from tpu_unet_torch.data.augment import augment_batch
from tpu_unet_torch.data.device_cache import DeviceResidentData
from tpu_unet_torch.data.device_pipeline import DevicePipeline
from tpu_unet_torch.evaluate import evaluate
from tpu_unet_torch.losses import bce_with_logits, cross_entropy, dice_loss
from tpu_unet_torch.models.unet import (
    UNetConfig,
    check_kernels,
    tree_leaves,
    tree_map,
    unet_apply,
)
from tpu_unet_torch.optim import clip_grad_norm, get_optimizer, get_scheduler
from tpu_unet_torch.parallel.mesh import (
    DataParallel,
    broadcast_tree,
    group_size,
    init_data_parallel,
    pmean,
    psum,
)
from tpu_unet_torch.parallel.multihost import spans_hosts
from tpu_unet_torch.parallel.zero import (
    gather_opt_state_zero,
    shard_opt_state_zero,
    zero_opt_shardings,
)
from tpu_unet_torch.train_checkpoints import CheckpointPolicy
from tpu_unet_torch.train_logging import LossDrain, WandbValidationPanel, init_wandb
from tpu_unet_torch.train_signals import StopSignal

logger = logging.getLogger(__name__)

dir_checkpoint = Path("./checkpoints/")


def compute_loss(logits: torch.Tensor, masks: torch.Tensor, n_classes: int,
                 dice_weight: float = 1.0, group=None) -> torch.Tensor:
    """The reference's criterion: BCE-with-logits + binary Dice on the
    squeezed channel (one class), else cross-entropy + multiclass Dice over
    the softmax. ``dice_weight`` scales the Dice term; 0 drops it.

    With ``group`` (data parallelism; JAX's ``axis_name``) it is the global
    batch's loss, the same on every rank: the CE means averaged over the
    ranks (equal shards), the Dice sums all-reduced before the division.
    Its gradients are then averaged over the ranks by the caller."""
    if n_classes == 1:
        logit = logits[..., 0]
        mask_f = masks.float()
        ce = bce_with_logits(logit, mask_f)
        dl = dice_loss(torch.sigmoid(logit), mask_f, group=group) if dice_weight else None
    else:
        mask_oh = torch.nn.functional.one_hot(masks.long(), n_classes).float()
        ce = cross_entropy(logits, masks)
        dl = (dice_loss(torch.softmax(logits, dim=-1), mask_oh, multiclass=True, group=group)
              if dice_weight else None)
    if group is not None:
        ce = psum(ce, group) / group_size(group)
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
    ``vmem_limit_kib`` (a TPU compiler option) is refused, not ignored.
    ``optimizer`` names the update rule (``optim/optimizers.py``), whose
    state the caller makes with the matching init; ``momentum`` None takes
    the optimizer's default. ``remat`` recomputes each block in the backward
    pass (``unet_apply``).

    ``return_grads`` appends the clipped gradients. ``accum_steps`` > 1 runs
    the batch as that many microbatches, microbatch j taking rows ``j::A``,
    with BN statistics per microbatch (the running stats thread through in
    order) and the gradients and loss averaged; a batch that ``accum_steps``
    does not divide runs unaccumulated.

    ``mesh`` (a ``parallel.mesh.DataParallel`` record, JAX's 1-D mesh) makes
    it JAX's ``shard_map`` step on both kernel routes: each rank passes the
    same trees and its rows of the global batch (``mesh.rows``); the BN and
    Dice sums are all-reduced inside autograd and the CE mean averaged
    (``group``), and the gradients of that replicated loss are averaged in
    one all-reduce before the clip, so every rank returns the same new
    trees, the global batch's loss and grad norm. With ``accum_steps``,
    microbatch j is each rank's rows ``j::A``, which are the global batch's
    rows ``j::A`` only when A divides each rank's rows: any other rank batch
    raises ValueError.

    ``opt_shardings`` (ZeRO-1: a ``parallel.zero.ZeroShardings`` of
    ``mesh``'s ranks; the state passed and returned is this rank's slice,
    ``shard_opt_state_zero``): after the same averaged, clipped gradients,
    each rank updates its slice of the params and the state, and one
    all-gather rebuilds the params, bitwise the plain step's."""
    if opt_shardings is not None and mesh is None:
        raise ValueError("make_train_step: opt_shardings (ZeRO) shards the optimizer state "
                         "over the ranks of a mesh; pass mesh")
    if vmem_limit_kib is not None:
        raise ValueError("make_train_step: vmem_limit_kib is a TPU compiler option")
    check_kernels(config, kernels)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    compute_dtype = torch.bfloat16 if amp else None
    group = None if mesh is None else mesh.group
    _, opt_update = get_optimizer(optimizer, weight_decay=weight_decay, momentum=momentum,
                                  nesterov=nesterov)

    def grads_and_loss(params, bn_state, images, masks):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        logits, new_bn = unet_apply(_unflatten(params, leaves), bn_state, images, config=config,
                                    train=True, compute_dtype=compute_dtype, remat=remat,
                                    kernels=kernels, group=group)
        loss = compute_loss(logits, masks, config.n_classes, dice_weight=dice_weight,
                            group=group)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), new_bn, list(grads)

    def step(params, bn_state, opt_state, images, masks, lr):
        n = images.shape[0]
        if group is not None and accum_steps > 1 and n % accum_steps:
            raise ValueError(f"accum_steps {accum_steps} must divide each rank's {n} rows "
                             "under data parallelism")
        if accum_steps == 1 or n % accum_steps:
            loss, new_bn, grads = grads_and_loss(params, bn_state, images, masks)
        else:
            new_bn, gsum, lsum = bn_state, None, 0.0
            for j in range(accum_steps):
                loss_j, new_bn, g = grads_and_loss(params, new_bn, images[j::accum_steps],
                                                   masks[j::accum_steps])
                gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
                lsum = lsum + loss_j
            inv = 1.0 / accum_steps
            grads = [g * inv for g in gsum]
            loss = lsum * inv
        if group is not None:
            grads = pmean(grads, group)
        grads, gnorm = clip_grad_norm(_unflatten(params, grads), grad_clip)
        if opt_shardings is None:
            new_params, new_opt = opt_update(grads, opt_state, params, lr)
        else:
            mine, new_opt = opt_update(opt_shardings.shard(grads), opt_state,
                                       opt_shardings.shard(params), lr)
            new_params = opt_shardings.gather(mine)
        out = (new_params, new_bn, new_opt, loss, gnorm)
        return out + (grads,) if return_grads else out

    return step


def warn_recurrent_rmsprop(arch: str, optimizer: str, momentum: float | None,
                           learning_rate: float) -> None:
    """Warn where the JAX package measured r2u/r2attu diverge: RMSprop with
    momentum >= 0.99 at lr >= 1e-4. The t=2 recurrence doubles the
    effective conv depth, and momentum 0.999 integrates about 1000
    normalised steps (``tpu_unet/train.py``; BENCH_NOTES r4, on a TPU)."""
    if (arch in ("r2u", "r2attu") and optimizer == "rmsprop"
            and (momentum is None or momentum >= 0.99) and learning_rate >= 1e-4):
        logger.warning(
            "--arch %s at lr %g under RMSprop(momentum>=0.99) diverged in the "
            "JAX package's TPU measurements (stable at ~3e-5); drop -l ~10x — or "
            "use --optimizer adam, measured there at this lr to beat the "
            "calibrated RMSprop recipe by +0.09-0.10 held-out Dice "
            "(ARCH_DEMOS.json r5).",
            arch, learning_rate)


def _check_train_flags(*, accum_steps, batch_size, early_stopping, kernels, world_size=None,
                       zero=False, data_parallel=False, multihost=False,
                       device_preprocess=False, tensor_parallel=1, pipeline_parallel=1):
    """Refuse invalid settings up front, with one clear error each (JAX's
    ``_check_train_flags`` and ``_build_loaders``' multi-host refusals).
    ``world_size``: the data-parallel ranks (None without data parallelism);
    ``multihost``: the world spans hosts. ``tensor_parallel`` and
    ``pipeline_parallel`` are not ported (the CLI refuses their flags);
    ``--zero``'s refusals of them stand here as in JAX."""
    if zero:
        # ZeRO-1 slices the optimizer state over the data-parallel ranks.
        if not data_parallel:
            raise ValueError("--zero requires --data-parallel")
        if kernels == "cuda":
            # JAX's "requires the XLA backend": its shard_map Pallas step pins
            # replicated state.
            raise ValueError("--zero requires the library route (--kernels torch, the JAX "
                             "package's XLA backend)")
        if multihost:
            raise ValueError("--zero is single-host for now (sharded optimizer state cannot be "
                             "fetched for checkpointing across processes)")
        if tensor_parallel > 1:
            raise ValueError("--zero is redundant with --tensor-parallel (tp already shards "
                             "the optimizer state)")
        if pipeline_parallel > 1:
            raise ValueError("--zero does not compose with --pipeline-parallel (stages hold "
                             "1/S of the state already)")
    if multihost:
        if not data_parallel:
            raise ValueError("multi-host training requires --data-parallel")
        if device_preprocess:
            raise ValueError("--device-preprocess is not supported under multi-host yet")
    if kernels not in (None, "cuda"):
        raise ValueError(f"kernels must be None or 'cuda', got {kernels!r}")
    if accum_steps > 1 and batch_size % accum_steps:
        raise ValueError(f"--accum-steps {accum_steps} must divide --batch-size {batch_size}")
    if early_stopping is not None and early_stopping < 1:
        raise ValueError(f"--early-stopping must be >= 1, got {early_stopping}")
    if world_size is not None:
        if batch_size % world_size:
            raise ValueError(f"--batch-size {batch_size} must divide over the {world_size} "
                             "data-parallel ranks")
        if accum_steps > 1 and (batch_size // world_size) % accum_steps:
            # Rank rows j::A are the global rows j::A only then (make_train_step).
            raise ValueError(f"--accum-steps {accum_steps} must divide each rank's "
                             f"{batch_size // world_size} rows (--batch-size {batch_size} over "
                             f"{world_size} data-parallel ranks)")


def _build_mesh(params, bn_state, *, data_parallel):
    """Data parallelism's set-up (JAX's ``_build_mesh``, 1-D): form or join
    the process group (``data_parallel`` True, on ``cuda:LOCAL_RANK`` for
    CUDA trees and the CPU for CPU ones) or take the record given, put the
    trees on its device and replicate rank 0's. Returns (params, bn_state,
    the record or None)."""
    if not data_parallel:
        return params, bn_state, None
    if isinstance(data_parallel, DataParallel):
        dp = data_parallel
    else:
        device = tree_leaves(params)[0].device
        dp = init_data_parallel(device=None if device.type == "cuda" else device)
    params, bn_state = (broadcast_tree(tree_map(lambda t: t.to(dp.device), tree), dp)
                        for tree in (params, bn_state))
    return params, bn_state, dp


def _place_opt_state(opt_state, params, dp: DataParallel | None, *, zero: bool = False):
    """The optimizer state's placement (JAX's ``_place_opt_state``): rank
    0's, replicated under data parallelism; with ``zero``, each rank keeps
    its 1/W slice of it. Returns (opt_state, opt_shardings), the latter a
    ``ZeroShardings`` with ``zero`` and None otherwise."""
    if dp is None:
        return opt_state, None
    opt_state = broadcast_tree(opt_state, dp)
    if not zero:
        return opt_state, None
    return (shard_opt_state_zero(dp, opt_state, params),
            zero_opt_shardings(dp, opt_state, params))


def _build_stepper(config, *, dp, **step_kw):
    """The train step, over the ranks of ``dp`` when it is given (JAX's
    ``_build_stepper``; the GPipe runner is not ported)."""
    return make_train_step(config, mesh=dp, **step_kw)


def _build_loaders(dataset, train_idx, val_idx, *, batch_size, seed, device,
                   device_dataset, device_preprocess, dp=None):
    """The train and val feeds: host loaders (decode threads), the corpus
    staged on the device, and/or the raw loaders' batches resized on the
    device (``dataset`` then a ``RawDataset``).

    Under data parallelism (``dp``) every rank draws the same seeded global
    order and loads only its rows of each global train batch, whole batches
    only (``drop_last``); the val feed gives global batches, which
    ``evaluate`` splits over the ranks. With ``device_dataset`` each rank
    stages its share of the corpus and every global batch is assembled by a
    collective (``DeviceResidentData(dp=)``). A world that spans hosts
    without ``device_dataset`` shards both feeds (JAX's ``MultiHostBatches``
    semantics): whole batches only, each rank loading its rows, the val
    batches marked ``"shard"`` for ``evaluate``; the val batch shrinks to
    ``min(batch_size, (n_val // W) · W)``, and a val split smaller than the
    world is refused."""
    shard = None if dp is None else (dp.rank, dp.world_size)
    if dp is not None and dp.multihost and not device_dataset:
        n_val, nproc = len(val_idx), dp.world_size
        val_batch = min(batch_size, (n_val // nproc) * nproc)
        if n_val and val_batch == 0:
            raise ValueError(f"validation split ({n_val} samples) is smaller than the process "
                             f"count ({nproc}); raise --validation or the dataset size for "
                             "multi-host training")
        val_batch = val_batch or batch_size
        for name, idx, bs in (("train", train_idx, batch_size), ("val", val_idx, val_batch)):
            if len(idx) % bs:
                logger.warning("multihost %s loader drops a trailing partial batch of %d "
                               "samples each epoch (all processes must agree on batch "
                               "shapes)", name, len(idx) % bs)
        train_loader = DataLoader(dataset, batch_size, shuffle=True, indices=train_idx,
                                  seed=seed, drop_last=True, shard=shard)
        val_loader = DataLoader(dataset, val_batch, indices=val_idx, drop_last=True,
                                shard=shard)
    elif device_dataset:
        if device_preprocess:
            raise ValueError("--device-dataset already preprocesses on host once; it is "
                             "mutually exclusive with --device-preprocess")
        dd = DeviceResidentData(dataset, device=device, dp=dp)
        train_loader = dd.batches(train_idx, batch_size, shuffle=True, seed=seed,
                                  drop_last=dp is not None, shard=shard)
        val_loader = dd.batches(val_idx, batch_size)
    else:
        train_loader = DataLoader(dataset, batch_size, shuffle=True, indices=train_idx,
                                  seed=seed, drop_last=dp is not None, shard=shard)
        val_loader = DataLoader(dataset, batch_size, shuffle=False, indices=val_idx)
    if device_preprocess:
        train_loader, val_loader = (
            DevicePipeline(loader, dataset.mask_values, dataset.scale, dataset.raw_h,
                           dataset.raw_w, device=device)
            for loader in (train_loader, val_loader))
    return train_loader, val_loader


def _restore_resume(resume, params, bn_state, opt_state, scheduler, *, config, optimizer,
                    lr_scheduler, learning_rate, dp=None):
    """Full-state resume: weights, BN state, optimizer state (when the file
    has it and was written by the same optimizer; otherwise weights only,
    with a warning), the schedule and the early-stopping bookkeeping.
    Returns (params, bn_state, opt_state, start_epoch, early_stop extra);
    the scheduler is updated in place. Every rank reads the file; rank 0's
    trees are then replicated (``dp``)."""
    _, prev_extra = read_checkpoint_meta(resume)
    saved_opt = prev_extra.get("optimizer", "rmsprop")
    opt_like = opt_state
    if saved_opt != optimizer:
        logger.warning("Resume checkpoint was written by optimizer %r but this run uses %r: "
                       "its optimizer state (if any) is discarded; weights, scheduler and "
                       "epoch still restore.", saved_opt, optimizer)
        opt_like = None
    device = tree_leaves(params)[0].device
    params, bn_state, _, extra = load_checkpoint(resume, config, device, opt_like=opt_like)
    if "opt_state" in extra:
        opt_state = extra.pop("opt_state")
    start_epoch = int(extra.get("epoch", 0)) + 1
    if "scheduler" in extra:
        sched_state = dict(extra["scheduler"])
        saved_sched = sched_state.pop("name", "plateau")
        if saved_sched == lr_scheduler:
            scheduler.load_state_dict(sched_state)
        else:
            logger.warning("Resume checkpoint used lr scheduler %r but this run uses %r: "
                           "starting the schedule fresh at lr %g.", saved_sched, lr_scheduler,
                           scheduler.lr)
    else:  # a checkpoint with the lr only
        scheduler.lr = float(extra.get("lr", learning_rate))
    logger.info("Resumed from %s at epoch %d (lr %g)", resume, start_epoch, scheduler.lr)
    if dp is not None:
        params, bn_state = broadcast_tree(params, dp), broadcast_tree(bn_state, dp)
    return params, bn_state, opt_state, start_epoch, extra.get("early_stop")


def _validation_pass(*, params, bn_state, opt_state, val_loader, config, amp, scheduler,
                     history, ema, early_stopping, es_best, es_bad, policy, panel, epoch,
                     global_step, images, masks, hist_batch, dp=None):
    """One validation: evaluate, step the schedule, early-stopping
    bookkeeping, the EMA weights' own validation, the best checkpoint, the
    W&B panel. Returns (es_best, es_bad, early_stopped). Under data
    parallelism (``dp``) every rank runs it: the evaluation is split over
    the ranks and gives every rank the same Dice."""
    val_dice, val_iou = evaluate(params, bn_state, val_loader, config, amp, mesh=dp)
    lr_now = scheduler.step(val_dice)
    history["val_dice"].append(val_dice)
    history["lr"].append(lr_now)
    logger.info("Validation Dice score: %f (IoU %f)", val_dice, val_iou)
    early_stopped = False
    if early_stopping is not None:
        if val_dice > es_best:
            es_best, es_bad = val_dice, 0
        else:
            es_bad += 1
            if es_bad >= early_stopping:
                early_stopped = True
                logger.info("Early stopping: no val Dice improvement in %d validations "
                            "(best %.4f)", early_stopping, es_best)
    if ema is not None:
        ema_dice, _ = evaluate(ema.params, bn_state, val_loader, config, amp, mesh=dp)
        history["val_dice_ema"].append(ema_dice)
        logger.info("Validation Dice (EMA): %f", ema_dice)
    policy.maybe_save_best(val_dice, epoch=epoch, step=global_step, lr=scheduler.lr,
                           params=params, bn_state=bn_state, opt_state=opt_state)
    panel.log(lr_now=lr_now, val_dice=val_dice, val_iou=val_iou, step=global_step, epoch=epoch,
              params=params, bn_state=bn_state, images=images, masks=masks,
              hist_batch=hist_batch)
    return es_best, es_bad, early_stopped


def train_model(params, bn_state, config: UNetConfig, *, dataset, epochs: int = 5,
                batch_size: int = 1, learning_rate: float = 1e-5, val_percent: float = 0.1,
                save_checkpoint_flag: bool = True, keep_checkpoints: int | None = None,
                save_best: bool = False, amp: bool = False, weight_decay: float = 1e-8,
                momentum: float | None = None, gradient_clipping: float = 1.0,
                optimizer: str = "rmsprop", nesterov: bool = False, dice_weight: float = 1.0,
                lr_scheduler: str = "plateau", lr_step_size: int = 10, lr_gamma: float = 0.1,
                lr_min: float = 0.0, remat: bool = False, use_wandb: bool = False,
                checkpoint_dir: Path = dir_checkpoint, seed: int = 0,
                save_optimizer: bool = False, resume: str | None = None,
                kernels: str | None = None, accum_steps: int = 1,
                ema_decay: float | None = None, val_per_epoch: int = 5,
                early_stopping: int | None = None, device_preprocess: bool = False,
                device_dataset: bool = False, augment=None,
                data_parallel: bool | DataParallel | None = False, zero: bool = False):
    """The reference's train loop on the port's step, with the JAX
    ``train_model``'s arguments but those of what the port does not have
    yet (spatial, tensor and pipeline parallelism).
    Trains on the device the params lie on; under ``data_parallel`` (True:
    form or join the process group; or a ``DataParallel`` record), on the
    rank's device with ``batch_size`` the global batch (module docstring),
    and with ``zero`` the optimizer state sliced over the ranks. A world
    that spans hosts (``multihost.spans_hosts``, or the record's
    ``multihost``) requires ``data_parallel``.
    ``use_wandb`` logs to W&B (``train_logging.py``): each step's loss and,
    at each validation, the scalars, a sample triplet and histograms.
    ``device_preprocess`` takes a ``RawDataset`` and resizes on the device;
    ``device_dataset`` stages the preprocessed corpus on the device (the two
    exclude each other); ``augment`` (an ``AugmentConfig``) augments each
    batch on the device with the draws of (``seed``, global step). Returns
    (params, bn_state, history) with history's ``train_loss`` per step and
    ``val_dice`` and ``lr`` per validation (``val_dice_ema`` with EMA)."""
    multihost = (data_parallel.multihost if isinstance(data_parallel, DataParallel)
                 else spans_hosts())
    flags = dict(accum_steps=accum_steps, batch_size=batch_size,
                 early_stopping=early_stopping, kernels=kernels, zero=zero,
                 data_parallel=bool(data_parallel), multihost=multihost,
                 device_preprocess=device_preprocess)
    _check_train_flags(**flags)
    params, bn_state, dp = _build_mesh(params, bn_state, data_parallel=data_parallel)
    world = 1 if dp is None else dp.world_size
    if dp is not None:
        _check_train_flags(**flags, world_size=world)
    primary = dp is None or dp.primary
    device = tree_leaves(params)[0].device
    train_idx, val_idx = random_split_indices(len(dataset), val_percent, seed=seed)
    n_train, n_val = len(train_idx), len(val_idx)
    train_loader, val_loader = _build_loaders(
        dataset, train_idx, val_idx, batch_size=batch_size, seed=seed, device=device,
        device_dataset=device_dataset, device_preprocess=device_preprocess, dp=dp)
    experiment = init_wandb(
        use_wandb and primary,
        dict(epochs=epochs, batch_size=batch_size, learning_rate=learning_rate,
             val_percent=val_percent, amp=amp, optimizer=optimizer, lr_scheduler=lr_scheduler,
             dice_weight=dice_weight, arch=config.arch))
    # Every rank runs the W&B panel's collective gradient pass when rank 0 logs.
    panel_on = experiment is not None if dp is None else dp.any(experiment is not None)
    logger.info("Starting training: arch=%s epochs=%d batch=%d lr=%g train=%d val=%d amp=%s "
                "optimizer=%s lr_scheduler=%s dice_weight=%g device=%s kernels=%s "
                "device_preprocess=%s device_dataset=%s augment=%s data_parallel_ranks=%d "
                "zero=%s multihost=%s",
                config.arch, epochs, batch_size, learning_rate, n_train, n_val, amp, optimizer,
                lr_scheduler, dice_weight, device, kernels, device_preprocess, device_dataset,
                augment, world, zero, multihost)
    warn_recurrent_rmsprop(config.arch, optimizer, momentum, learning_rate)

    opt_init, _ = get_optimizer(optimizer, weight_decay=weight_decay, momentum=momentum,
                                nesterov=nesterov)
    opt_state = opt_init(params)
    scheduler = get_scheduler(lr_scheduler, learning_rate, epochs=epochs, step_size=lr_step_size,
                              gamma=lr_gamma, eta_min=lr_min)
    start_epoch = 1
    resume_es = None  # the early-stopping (best, bad) of the resumed run
    if resume:
        params, bn_state, opt_state, start_epoch, resume_es = _restore_resume(
            resume, params, bn_state, opt_state, scheduler, config=config, optimizer=optimizer,
            lr_scheduler=lr_scheduler, learning_rate=learning_rate, dp=dp)
    opt_state, opt_shardings = _place_opt_state(opt_state, params, dp, zero=zero)
    train_step = _build_stepper(
        config, dp=dp, amp=amp, remat=remat, weight_decay=weight_decay, momentum=momentum,
        grad_clip=gradient_clipping, kernels=kernels, accum_steps=accum_steps,
        optimizer=optimizer, nesterov=nesterov, dice_weight=dice_weight,
        opt_shardings=opt_shardings)
    panel = WandbValidationPanel(experiment, config=config, amp=amp, remat=remat,
                                 dice_weight=dice_weight, accum_steps=accum_steps,
                                 group=None if dp is None else dp.group, enabled=panel_on,
                                 multihost=multihost)
    ema = train_ema.maybe_create(ema_decay, params,
                                 total_steps=(epochs - start_epoch + 1) * max(1, len(train_loader)))
    if ema is not None and resume:
        ema.resume_from_sibling(resume, params)

    history: dict[str, list] = {"train_loss": [], "val_dice": [], "lr": []}
    if ema is not None:
        history["val_dice_ema"] = []
    global_step = 0
    hist_batch = None  # the last full-size batch, for the W&B gradient histograms
    # The reference validates 5 times an epoch: division_step = n_train // (5·B).
    division_step = n_train // (max(1, val_per_epoch) * batch_size)
    policy = CheckpointPolicy(
        checkpoint_dir, enabled=save_checkpoint_flag, primary=primary, keep=keep_checkpoints,
        save_best=save_best, save_optimizer=save_optimizer, optimizer=optimizer,
        lr_scheduler=lr_scheduler, config=config, dataset=dataset, ema_decay=ema_decay,
        full_opt=(None if opt_shardings is None
                  else lambda o: gather_opt_state_zero(o, opt_shardings)),
        agree=None if dp is None else dp.any)
    interrupted = early_stopped = False
    es_best, es_bad = -float("inf"), 0
    if resume_es:
        es_best = float(resume_es.get("best", es_best))
        es_bad = int(resume_es.get("bad", es_bad))
    last_epoch = start_epoch - 1
    drain = LossDrain(history, experiment)

    with StopSignal() as stop:
        for epoch in range(start_epoch, epochs + 1):
            # Batches of the device paths are made on the device already.
            feed = (train_loader if device_dataset or device_preprocess
                    else prefetch_to_device(train_loader, buffer_size=2, device=device))
            for batch in feed:
                # Act at this batch boundary, on every rank when any was signalled.
                if stop.requested if dp is None else dp.any(stop.requested):
                    interrupted = True
                    break
                images, masks = batch["image"], batch["mask"]
                if augment is not None:
                    # Under data parallelism: the draws of the rank's global rows.
                    shard = {} if dp is None else {"shard": (dp.rank, dp.world_size)}
                    images, masks = augment_batch(images, masks, config=augment, seed=seed,
                                                  step=global_step, **shard)
                params, bn_state, opt_state, loss, _ = train_step(
                    params, bn_state, opt_state, images, masks, scheduler.lr)
                if ema is not None:
                    ema.update(params)
                global_step += 1
                if panel_on and images.shape[0] == batch_size // world:
                    # The histograms sample the last full batch, as the JAX
                    # package's do: never a trailing partial one.
                    hist_batch = (images, masks)
                drain.append(loss, global_step, epoch)
                if division_step > 0 and global_step % division_step == 0:
                    drain.drain()
                    es_best, es_bad, stopped = _validation_pass(
                        params=params, bn_state=bn_state, opt_state=opt_state,
                        val_loader=val_loader, config=config, amp=amp, scheduler=scheduler,
                        history=history, ema=ema, early_stopping=early_stopping,
                        es_best=es_best, es_bad=es_bad, policy=policy, panel=panel,
                        epoch=epoch, global_step=global_step, images=images, masks=masks,
                        hist_batch=hist_batch, dp=dp)
                    early_stopped = early_stopped or stopped
                if early_stopped:
                    break
            drain.drain()
            if interrupted:
                path = policy.save_interrupted(
                    epoch=epoch, step=global_step, scheduler=scheduler, es_best=es_best,
                    es_bad=es_bad, params=params, bn_state=bn_state, opt_state=opt_state,
                    ema_params=ema.params if ema is not None else None)
                if path is not None:
                    logger.info("Training interrupted: resumable checkpoint saved to %s "
                                "(continue with --resume %s)", path, path)
                break
            epoch_losses = history["train_loss"][-len(train_loader):]
            logger.info("Epoch %d finished, mean loss %f", epoch,
                        float(np.mean(epoch_losses)) if epoch_losses else float("nan"))
            # Epoch schedules advance here (torch's scheduler.step() call
            # point); the checkpoint below carries the advanced state.
            scheduler.epoch_end()
            policy.save_epoch(epoch, params=params, bn_state=bn_state, opt_state=opt_state,
                              scheduler=scheduler, es_best=es_best, es_bad=es_bad,
                              ema_params=ema.params if ema is not None else None)
            last_epoch = epoch
            if early_stopped:
                logger.info("Stopped early during epoch %d.", epoch)
                break
    policy.finish(last_epoch, start_epoch, epochs)
    if dp is not None:
        dp.barrier()  # rank 0's files are written before any rank returns
    return params, bn_state, history
