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

Spatial parallelism (``spatial_parallel`` S > 1 with data parallelism over
more than one rank; JAX's 2-D mesh) forms a (W/S) x S ``parallel.mesh.Grid``:
each rank trains on its data coordinate's rows of each global batch and its
height band of each image (the feeds cut both; augmentation, when on, runs
on whole rows first). The forward exchanges halo rows inside autograd
(``parallel/halo.py``) and the BN, Dice and CE sums go over the whole grid,
so the step is still the one-process step at the same global batch; ZeRO
slices over the data axis only; validation splits batches that divide over
the grid; the W&B panel's gradient pass runs over the grid and its sample
triplet is the whole first image.

Tensor parallelism (``tensor_parallel`` T > 1 with data parallelism over
more than one rank; JAX's 3-D mesh) adds the model axis to the grid (W/(S·T)
x S x T): rank 0's full trees are broadcast, then each rank keeps its
channel shards (``parallel/tensor.py``). The T ranks of one (data, spatial)
coordinate train on the same rows and band; every sum over the batch goes
over the replica group. Each rank evaluates its rows with its shards, and
every rank gathers the full params, BN state, optimizer state and EMA
weights before rank 0 writes a checkpoint, which is then the file a
one-process run writes.

Pipeline parallelism (``pipeline_parallel`` S > 1; GPipe,
``parallel/pipeline.py``) splits the U-Net over S devices in this one
process: ``cuda:0`` .. ``cuda:S-1``, or the CPU S times for CPU trees. The
``accum_steps`` is its microbatch count (default S). The full trees are
gathered onto the first device at each validation, each epoch's end and
the end. It takes RMSprop only and composes with none of the other axes.
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
    init_unet,
    tree_leaves,
    tree_map,
    unet_apply,
)
from tpu_unet_torch.optim import clip_grad_norm, get_optimizer, get_scheduler
from tpu_unet_torch.parallel.mesh import (
    DataParallel,
    Grid,
    broadcast_tree,
    group_size,
    init_data_parallel,
    make_grid,
    pmean,
    psum,
)
from tpu_unet_torch.parallel.multihost import spans_hosts
from tpu_unet_torch.parallel.tensor import (
    dims_in_order,
    gather_model,
    gather_opt_state,
    model_specs,
    shard_model,
    shard_opt_state,
    shard_params,
)
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
    Its gradients are then averaged over the ranks by the caller. A
    ``parallel.mesh.Grid``'s logits are each rank's rows and height band,
    all the same size (the input's height divides over the spatial ranks):
    the CE means averaged and the Dice sums all-reduced over the whole grid
    give the global pixel mean and the global ratio."""
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
    all-gather rebuilds the params, bitwise the plain step's.

    ``mesh`` a ``parallel.mesh.Grid`` (spatial parallelism, library route):
    each rank passes its rows and height band (``mesh.bands``), and the
    model exchanges halo rows inside autograd. The loss is still replicated:
    every rank's copy of the loss (and of each BN's statistics) reaches its
    local activations through ``psum``, whose backward sums the W equal
    cotangents, and a halo row's cotangent is added into its owner's, so
    each rank's parameter gradient is W times its band's share of the
    global gradient, whatever the split; the mean over the world's W ranks
    is the global gradient, as in the 1-D step.

    A grid with a model axis (tensor parallelism, ``parallel/tensor.py``)
    takes the trees as this rank's shards (``shard_model``,
    ``shard_opt_state``) and the rows and band of its (data, spatial)
    coordinate, the same on each of its model ranks: every sum over the
    batch and the sharded gradients' mean go over the replica group (the
    replicated gradients' over the world: ``_pmean_model``), the clip's
    norm counts each sharded leaf once, and each rank updates its shards."""
    model = getattr(mesh, "model_size", 1)
    if model > 1 and kernels == "cuda":
        raise ValueError("--kernels cuda data parallelism is 1-D (shard_map); "
                         "--tensor-parallel requires the XLA backend (--kernels torch)")
    if opt_shardings is not None and mesh is None:
        raise ValueError("make_train_step: opt_shardings (ZeRO) shards the optimizer state "
                         "over the ranks of a mesh; pass mesh")
    if vmem_limit_kib is not None:
        raise ValueError("make_train_step: vmem_limit_kib is a TPU compiler option")
    check_kernels(config, kernels)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    compute_dtype = torch.bfloat16 if amp else None
    group = None if mesh is None else mesh if isinstance(mesh, Grid) else mesh.group
    _, opt_update = get_optimizer(optimizer, weight_decay=weight_decay, momentum=momentum,
                                  nesterov=nesterov)
    dims = model_specs(config, model)[0] if model > 1 else None

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
        clip = {}
        if model > 1:
            sharded = [d is not None for d in dims_in_order(params, dims)]
            grads = _pmean_model(grads, sharded, mesh)
            clip = {"sharded": sharded, "group": mesh.model_group}
        elif group is not None:
            grads = pmean(grads, group)
        grads, gnorm = clip_grad_norm(_unflatten(params, grads), grad_clip, **clip)
        if opt_shardings is None:
            new_params, new_opt = opt_update(grads, opt_state, params, lr)
        else:
            mine, new_opt = opt_update(opt_shardings.shard(grads), opt_state,
                                       opt_shardings.shard(params), lr)
            new_params = opt_shardings.gather(mine)
        out = (new_params, new_bn, new_opt, loss, gnorm)
        return out + (grads,) if return_grads else out

    return step


def _pmean_model(grads: list, sharded: list[bool], grid) -> list:
    """The gradients' mean under a model axis: each sharded leaf's over the
    replica group; each replicated leaf's over the world, the same value
    (its T model copies are equal but for the order of nondeterministic
    kernels, e.g. cuDNN's fp32 weight gradients), so that the model ranks'
    replicated params stay bitwise equal."""
    parts = [pmean([g for g, f in zip(grads, sharded) if f == want], group)
             for want, group in ((True, grid), (False, grid.group))]
    its = [iter(parts[0]), iter(parts[1])]
    return [next(its[0] if f else its[1]) for f in sharded]


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


def check_grid(world_size: int, spatial_parallel: int, kernels, tensor_parallel: int = 1) -> bool:
    """JAX's ``_build_mesh`` refusals of a spatial or model axis; whether
    the run forms the (data x spatial x model) grid: only with more than one
    rank, as JAX builds no mesh on one device (``--spatial-parallel`` and
    ``--tensor-parallel`` then train as the plain run)."""
    if world_size <= 1 or (spatial_parallel <= 1 and tensor_parallel <= 1):
        return False
    if kernels == "cuda":
        axis = "--tensor-parallel" if tensor_parallel > 1 else "--spatial-parallel"
        raise ValueError("--kernels cuda data parallelism is 1-D (shard_map); "
                         f"{axis} requires the XLA backend (--kernels torch)")
    if tensor_parallel > 1 and world_size % (spatial_parallel * tensor_parallel):
        raise ValueError(f"{world_size} devices not divisible by spatial·model = "
                         f"{spatial_parallel}·{tensor_parallel}")
    if world_size % spatial_parallel:
        raise ValueError(f"{world_size} devices not divisible by spatial={spatial_parallel}")
    return True


def _check_train_flags(*, accum_steps, batch_size, early_stopping, kernels, world_size=None,
                       zero=False, data_parallel=False, multihost=False,
                       device_preprocess=False, tensor_parallel=1, pipeline_parallel=1,
                       spatial_parallel=1, optimizer="rmsprop", ema_decay=None, remat=False):
    """Refuse invalid settings up front, with one clear error each (JAX's
    ``_check_train_flags`` and ``_build_loaders``' multi-host refusals).
    ``world_size``: the data-parallel ranks, a grid's data axis (None
    without data parallelism); ``multihost``: the world spans hosts. The
    refusals of a spatial or model axis that need the world size are
    ``check_grid``'s."""
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
    if tensor_parallel > 1 and not data_parallel:
        # The model axis is part of the one grid; a tp-only run is the grid
        # with data axis 1, reached the same way.
        raise ValueError("--tensor-parallel requires --data-parallel (the data axis may still "
                         "end up size 1)")
    if pipeline_parallel > 1:
        # GPipe gives whole devices to stages: an alternative to the grid's
        # axes, not a fourth one.
        if optimizer != "rmsprop":
            raise ValueError("--pipeline-parallel supports the reference RMSprop only (the "
                             "stage runner splits RMSpropState by stage; "
                             "parallel/pipeline.py)")
        if data_parallel or spatial_parallel > 1 or tensor_parallel > 1:
            raise ValueError("--pipeline-parallel does not compose with --data-parallel/"
                             "--spatial-parallel/--tensor-parallel (depth partitioning claims "
                             "whole devices; use the dp×sp×tp mesh for those regimes)")
        if kernels == "cuda":
            raise ValueError("--pipeline-parallel requires the XLA backend (--kernels torch)")
        if ema_decay is not None:
            raise ValueError("--ema-decay is not supported with --pipeline-parallel (the "
                             "shadow tree would need per-step gathers)")
        if multihost:
            raise ValueError("--pipeline-parallel is single-host (stage-placed devices); use "
                             "--multihost with the GSPMD axes instead")
        if remat:
            logger.info("--pipeline-parallel implies per-stage recompute; remat flag is "
                        "redundant and ignored")
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


def _build_mesh(params, bn_state, *, data_parallel, spatial_parallel: int = 1,
                tensor_parallel: int = 1, kernels=None):
    """Data parallelism's set-up (JAX's ``_build_mesh``): form or join the
    process group (``data_parallel`` True, on ``cuda:LOCAL_RANK`` for CUDA
    trees and the CPU for CPU ones) or take the record given, form the
    (data x spatial x model) grid over its ranks when ``check_grid`` says
    so, put the trees on its device and replicate rank 0's over the world;
    with a model axis, each rank then keeps its shards
    (``parallel.tensor.shard_model``). Returns (params, bn_state, the record
    or None)."""
    if not data_parallel:
        return params, bn_state, None
    if isinstance(data_parallel, DataParallel):
        dp = data_parallel
    else:
        device = tree_leaves(params)[0].device
        dp = init_data_parallel(device=None if device.type == "cuda" else device)
    if not isinstance(dp, Grid) and check_grid(dp.world_size, spatial_parallel, kernels,
                                               tensor_parallel):
        dp = make_grid(dp, spatial_parallel, tensor_parallel)
    params, bn_state = (broadcast_tree(tree_map(lambda t: t.to(dp.device), tree), dp)
                        for tree in (params, bn_state))
    if getattr(dp, "model_size", 1) > 1:
        params, bn_state = shard_model(dp, params, bn_state)
    return params, bn_state, dp


def _place_opt_state(opt_state, params, dp: DataParallel | None, *, zero: bool = False):
    """The optimizer state's placement (JAX's ``_place_opt_state``): rank
    0's, replicated under data parallelism; with ``zero``, each rank keeps
    its 1/D slice of it, D the data axis (the world, or a grid's data
    ranks; replicated over the spatial ones); with a model axis, each
    rank's shards as they come. Returns (opt_state, opt_shardings), the
    latter a ``ZeroShardings`` with ``zero`` and None otherwise."""
    if dp is None:
        return opt_state, None
    if getattr(dp, "model_size", 1) > 1:
        # Each rank's shards already: the optimizer's init of its shards, or
        # the resume's (_restore_resume).
        return opt_state, None
    opt_state = broadcast_tree(opt_state, dp)
    if not zero:
        return opt_state, None
    return (shard_opt_state_zero(dp, opt_state, params),
            zero_opt_shardings(dp, opt_state, params))


def _build_stepper(params, bn_state, opt_state, config, *, dp, pipeline_parallel: int = 1,
                   devices=None, **step_kw):
    """The GPipe runner or the train step (JAX's ``_build_stepper``):
    (pipeline, None) with ``pipeline_parallel`` S > 1, its microbatches
    ``accum_steps`` (default S) and its stages on ``devices``; otherwise
    (None, the step over the ranks of ``dp`` when it is given)."""
    if pipeline_parallel <= 1:
        return None, make_train_step(config, mesh=dp, **step_kw)
    from tpu_unet_torch.parallel.pipeline import PipelineRunner

    accum, momentum = step_kw["accum_steps"], step_kw["momentum"]
    microbatches = accum if accum > 1 else pipeline_parallel
    pipeline = PipelineRunner(
        params, bn_state, config, n_stages=pipeline_parallel, microbatches=microbatches,
        opt_state=opt_state, amp=step_kw["amp"], weight_decay=step_kw["weight_decay"],
        momentum=0.999 if momentum is None else momentum, grad_clip=step_kw["grad_clip"],
        dice_weight=step_kw["dice_weight"], devices=devices)
    logger.info("Pipeline parallelism: %d stages %s over %s, %d microbatches/step",
                pipeline_parallel,
                [f"{st[0]}..{st[-1]}" if len(st) > 1 else st[0] for st in pipeline.stages],
                [str(d) for d in pipeline.devices], microbatches)
    return pipeline, None


def _build_loaders(dataset, train_idx, val_idx, *, batch_size, seed, device,
                   device_dataset, device_preprocess, dp=None, whole_rows=False):
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
    world is refused.

    On a grid the rows are those of the rank's data coordinate (W its data
    ranks above) and the train batches, and sharded val batches, are cut
    to the rank's height band too, but with ``whole_rows`` (augmentation,
    or the resize on the device): the loop cuts the band after those."""
    shard = None if dp is None else dp.shard
    band = None if dp is None else dp.band
    train_band = None if whole_rows else band
    if dp is not None and dp.multihost and not device_dataset:
        n_val, nproc = len(val_idx), dp.data_size
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
                                  seed=seed, drop_last=True, shard=shard, band=train_band)
        val_loader = DataLoader(dataset, val_batch, indices=val_idx, drop_last=True,
                                shard=shard, band=band)
    elif device_dataset:
        if device_preprocess:
            raise ValueError("--device-dataset already preprocesses on host once; it is "
                             "mutually exclusive with --device-preprocess")
        dd = DeviceResidentData(dataset, device=device, dp=dp)
        train_loader = dd.batches(train_idx, batch_size, shuffle=True, seed=seed,
                                  drop_last=dp is not None, shard=shard, band=train_band)
        val_loader = dd.batches(val_idx, batch_size)
    else:
        train_loader = DataLoader(dataset, batch_size, shuffle=True, indices=train_idx,
                                  seed=seed, drop_last=dp is not None, shard=shard,
                                  band=train_band)
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
    trees are then replicated (``dp``) and, with a model axis, re-sharded."""
    _, prev_extra = read_checkpoint_meta(resume)
    saved_opt = prev_extra.get("optimizer", "rmsprop")
    opt_like = opt_state
    if saved_opt != optimizer:
        logger.warning("Resume checkpoint was written by optimizer %r but this run uses %r: "
                       "its optimizer state (if any) is discarded; weights, scheduler and "
                       "epoch still restore.", saved_opt, optimizer)
        opt_like = None
    device = tree_leaves(params)[0].device
    sharded = getattr(dp, "model_size", 1) > 1
    if sharded and opt_like is not None:  # the file holds the full state
        opt_like = get_optimizer(optimizer)[0](
            init_unet(config, np.random.default_rng(0), device="meta")[0])
    params, bn_state, _, extra = load_checkpoint(resume, config, device, opt_like=opt_like)
    loaded_opt = "opt_state" in extra
    if loaded_opt:
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
        if sharded:  # re-shard what the file held whole
            if loaded_opt:
                opt_state = shard_opt_state(dp, broadcast_tree(opt_state, dp), params)
            params, bn_state = shard_model(dp, params, bn_state)
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
                data_parallel: bool | DataParallel | None = False, zero: bool = False,
                spatial_parallel: int = 1, tensor_parallel: int = 1,
                pipeline_parallel: int = 1):
    """The reference's train loop on the port's step, with the JAX
    ``train_model``'s arguments.
    Trains on the device the params lie on; under ``data_parallel`` (True:
    form or join the process group; or a ``DataParallel`` record), on the
    rank's device with ``batch_size`` the global batch (module docstring),
    and with ``zero`` the optimizer state sliced over the data ranks.
    ``spatial_parallel`` S > 1 and ``tensor_parallel`` T > 1 with more than
    one rank split each image's height over S of them and each sharded
    block's channels over T (a (W/(S·T)) x S x T grid; a ``Grid`` record
    given as ``data_parallel`` is used as it is); W must divide by S·T, and
    the library route is required, as in JAX. ``pipeline_parallel`` S > 1
    runs the GPipe stages in this process (module docstring). A world that
    spans hosts (``multihost.spans_hosts``, or the record's ``multihost``)
    requires ``data_parallel``.
    ``use_wandb`` logs to W&B (``train_logging.py``): each step's loss and,
    at each validation, the scalars, a sample triplet and histograms.
    ``device_preprocess`` takes a ``RawDataset`` and resizes on the device;
    ``device_dataset`` stages the preprocessed corpus on the device (the two
    exclude each other); ``augment`` (an ``AugmentConfig``) augments each
    batch on the device with the draws of (``seed``, global step). Returns
    (params, bn_state, history) with history's ``train_loss`` per step and
    ``val_dice`` and ``lr`` per validation (``val_dice_ema`` with EMA); the
    params and BN state whole, gathered from a model axis or the stages."""
    multihost = (data_parallel.multihost if isinstance(data_parallel, DataParallel)
                 else spans_hosts())
    flags = dict(accum_steps=accum_steps, batch_size=batch_size,
                 early_stopping=early_stopping, kernels=kernels, zero=zero,
                 data_parallel=bool(data_parallel), multihost=multihost,
                 device_preprocess=device_preprocess, tensor_parallel=tensor_parallel,
                 pipeline_parallel=pipeline_parallel, spatial_parallel=spatial_parallel,
                 optimizer=optimizer, ema_decay=ema_decay, remat=remat)
    _check_train_flags(**flags)
    params, bn_state, dp = _build_mesh(params, bn_state, data_parallel=data_parallel,
                                       spatial_parallel=spatial_parallel,
                                       tensor_parallel=tensor_parallel, kernels=kernels)
    world = 1 if dp is None else dp.data_size
    grid = dp if isinstance(dp, Grid) else None
    model = 1 if grid is None else grid.model_size
    if dp is not None:
        _check_train_flags(**flags, world_size=world)
    primary = dp is None or dp.primary
    device = tree_leaves(params)[0].device
    train_idx, val_idx = random_split_indices(len(dataset), val_percent, seed=seed)
    n_train, n_val = len(train_idx), len(val_idx)
    train_loader, val_loader = _build_loaders(
        dataset, train_idx, val_idx, batch_size=batch_size, seed=seed, device=device,
        device_dataset=device_dataset, device_preprocess=device_preprocess, dp=dp,
        whole_rows=augment is not None or device_preprocess)
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
                "spatial_ranks=%d model_ranks=%d pipeline_stages=%d zero=%s multihost=%s",
                config.arch, epochs, batch_size, learning_rate, n_train, n_val, amp, optimizer,
                lr_scheduler, dice_weight, device, kernels, device_preprocess, device_dataset,
                augment, world, 1 if grid is None else grid.spatial_size, model,
                pipeline_parallel, zero, multihost)
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
    pipeline, train_step = _build_stepper(
        params, bn_state, opt_state, config, dp=dp, pipeline_parallel=pipeline_parallel,
        devices=[device] * pipeline_parallel if device.type == "cpu" else None, amp=amp,
        remat=remat, weight_decay=weight_decay, momentum=momentum,
        grad_clip=gradient_clipping, kernels=kernels, accum_steps=accum_steps,
        optimizer=optimizer, nesterov=nesterov, dice_weight=dice_weight,
        opt_shardings=opt_shardings)
    # Under a model axis every rank gathers the full trees where they leave
    # the run: checkpoints, the W&B panel's histograms and sample.
    full = None if model == 1 else (
        lambda p, s, *more: gather_model(grid, p, s, config, *more))
    panel = WandbValidationPanel(experiment, config=config, amp=amp, remat=remat,
                                 dice_weight=dice_weight, accum_steps=accum_steps,
                                 group=None if dp is None else grid or dp.group,
                                 enabled=panel_on, multihost=multihost, full=full)
    ema = train_ema.maybe_create(ema_decay, params,
                                 total_steps=(epochs - start_epoch + 1) * max(1, len(train_loader)))
    if ema is not None and resume:
        ema.resume_from_sibling(resume, params,
                                place=None if model == 1 else lambda t: shard_params(grid, t))

    history: dict[str, list] = {"train_loss": [], "val_dice": [], "lr": []}
    if ema is not None:
        history["val_dice_ema"] = []
    global_step = 0
    hist_batch = None  # the last full-size batch, for the W&B gradient histograms
    # The reference validates 5 times an epoch: division_step = n_train // (5·B).
    division_step = n_train // (max(1, val_per_epoch) * batch_size)
    if opt_shardings is not None:
        full_opt = lambda o: gather_opt_state_zero(o, opt_shardings)  # noqa: E731
    elif model > 1:
        full_opt = lambda o: gather_opt_state(grid, o, config)  # noqa: E731
    else:
        full_opt = None
    policy = CheckpointPolicy(
        checkpoint_dir, enabled=save_checkpoint_flag, primary=primary, keep=keep_checkpoints,
        save_best=save_best, save_optimizer=save_optimizer, optimizer=optimizer,
        lr_scheduler=lr_scheduler, config=config, dataset=dataset, ema_decay=ema_decay,
        full_opt=full_opt, full_model=full, agree=None if dp is None else dp.any)
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
                    shard = {} if dp is None else {"shard": dp.shard}
                    images, masks = augment_batch(images, masks, config=augment, seed=seed,
                                                  step=global_step, **shard)
                if grid is not None and (augment is not None or device_preprocess):
                    # Whole rows augmented or resized: now the rank's band.
                    images, masks = grid.cut_band(images), grid.cut_band(masks)
                if pipeline is not None:
                    loss, _ = pipeline.step(images, masks, scheduler.lr)
                else:
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
                    if pipeline is not None:  # the full trees, from the stages
                        params, bn_state, opt_state = pipeline.gather()
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
            if pipeline is not None:  # for the checkpoints and the interrupt save
                params, bn_state, opt_state = pipeline.gather()
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
    if pipeline is not None:
        params, bn_state, _ = pipeline.gather()
    elif full is not None:
        params, bn_state = full(params, bn_state)
    policy.finish(last_epoch, start_epoch, epochs)
    if dp is not None:
        dp.barrier()  # rank 0's files are written before any rank returns
    return params, bn_state, history
