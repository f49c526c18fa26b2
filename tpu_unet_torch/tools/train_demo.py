"""The quality gates on the card (``tools/train_demo.py``): train on
synthetic Carvana-like data and hold the result to the JAX package's
frozen Dice floors.

A run makes ``n`` training images from the preset's generator and a
held-out set from an unseen seed and unseen generator ranges
(``HELDOUT_GEN``), trains the full-width model with ``train_model`` (bf16 and
the corpus staged on the device on a GPU, 1/6 held for validation), then
scores the validation split, the held-out set, and the held-out set under
flip and hflip TTA. It passes when the validation Dice meets the preset's
floor and, where there is one, the held-out Dice meets the held-out floor;
``main`` exits 1 otherwise. The presets, generators, floors and per-family
recipes are the JAX package's, verbatim: they are frozen, and are never
tuned against a result of this port.

Run (on a GPU; ``--device cpu`` for the CPU):
    python -m tpu_unet_torch.tools.train_demo --preset carvana [--out result.json]
    python -m tpu_unet_torch.tools.train_demo --preset arch --arch unet|unetpp|attention|r2u|r2attu \
        [--kernels cuda] [--out result.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from tpu_unet_torch.utils.determinism import Deterministic

logger = logging.getLogger(__name__)


# The JAX package's tables, verbatim. "On chip" in their comments means the
# TPU runs recorded in TRAINING_DEMO.json and ARCH_DEMOS.json.
PRESETS = {
    # name: (h, w, n_imgs, base_channels, batch, lr, epochs, dice_floor,
    #        heldout_floor) — heldout_floor gates Dice on a HELD-OUT
    # generator configuration (unseen seed AND unseen parameter ranges:
    # backdrop luminance, shadow strength/offset, car luminance band, glare
    # distractor — data/synthetic.py::HELDOUT_GEN). The v3 training
    # generator is frozen; hardening the claim against tuning-on-the-gate
    # is VERDICT r2 weak #1 / next #3. None = report but don't gate.
    "full": (160, 224, 48, 64, 8, 3e-4, 40, 0.93, 0.90),
    # The reference's training resolution (Carvana 1918×1280 at the default
    # --scale 0.5 → 959×640; SURVEY.md §6) with the 31M flagship — the
    # floor matches the reference README's 0.9884 Dice quality claim.
    # (n=128/15ep reached only 0.879: train loss 0.016 but a generalization
    # gap on 107 train images — more data, not more epochs, is the lever.)
    "carvana": (640, 959, 384, 64, 8, 3e-4, 12, 0.988, 0.98),
    # Calibrated on CPU (round 2): this sizing reaches val Dice ~0.71 in
    # ~3.5 min; a broken train path lands ~0.3, so 0.65 separates cleanly.
    # Held-out reported but ungated at toy scale (too noisy to separate).
    "ci": (64, 96, 48, 16, 4, 1e-3, 25, 0.65, None),
    # Family-comparison scale (VERDICT r3 next #2): 320×480 — the shape the
    # BENCH_NOTES family throughput characterizations used — big enough for
    # real segmentation, small enough that UNet++'s dense grid fits HBM.
    # Preset floors are report-only; per-family floors live in ARCH_FLOORS.
    "arch": (320, 480, 128, 64, 8, 3e-4, 20, 0.0, None),
    # Flip-symmetric overhead scenes (VERDICT r3 next #4): the distribution
    # where TTA/augmentation's precondition holds BY CONSTRUCTION — the
    # positive-lever measurement to set against the gravity-axis negatives
    # (BENCH_NOTES r3). Report-only floors; sized like "full".
    "overhead": (160, 224, 48, 64, 8, 3e-4, 40, 0.0, None),
}

# Preset-specific generator configs: (train_gen, heldout_gen); None entries
# mean the frozen defaults (v3 TRAIN_GEN / HELDOUT_GEN).
PRESET_GENS = {
    "overhead": ("OVERHEAD_GEN", "OVERHEAD_HELDOUT_GEN"),
}

# Held-out set sizing: default max(8, n//8). The overhead preset exists to
# measure ±0.001-scale lever deltas (TTA/augment/EMA), and 8 held-out
# images put those under the noise floor — it evaluates 64 instead
# (eval-only cost; its floors are report-only so no frozen gate moves).
PRESET_HELDOUT_N = {
    "overhead": 64,
}

HELDOUT_SEED = 4242  # never used by any training/val dataset generation

# Per-family quality floors (VERDICT r3 next #2): the flagship's floors live
# in PRESETS; beyond-reference families gate once a calibrated on-chip run
# exists. (val_floor, heldout_floor); None = report-only first run, then
# calibrated with headroom under the measured Dice (ARCH_DEMOS.json).
ARCH_FLOORS: dict[str, tuple[float, float] | None] = {
    # Calibrated from on-chip arch-preset runs (ARCH_DEMOS.json), measured
    # Dice minus a 0.03 margin. The margin is NOT sampling noise — the
    # seeded runs are bit-deterministic on chip (r5 gated re-runs
    # reproduced r4's unet 0.9772/0.9685 and r5's r2u 0.9970/0.9850
    # exactly); it is headroom for recipe-neutral code drift (XLA/jax
    # upgrades, numerics-affecting refactors). unet gates on the arch
    # preset too (its preset floors are calibrated for "full"/"carvana"
    # sizings, not 320×480/20ep). unet/unetpp/attention calibrated r4;
    # r2u/r2attu recalibrated r5 on the adam + per-step-BN recipe
    # (demo_runs/*_adam_psbn.json) — the r4 rmsprop floors (0.888/0.860,
    # 0.898/0.860) belonged to the shared-BN eval pathology era.
    "unet": (0.947, 0.939),       # measured val 0.9772 / heldout 0.9685
    "unetpp": (0.965, 0.952),     # measured 0.9949 / 0.9816
    "attention": (0.954, 0.959),  # measured 0.9835 / 0.9887
    "r2u": (0.967, 0.955),        # measured 0.9970 / 0.9850 (r5 recipe)
    "r2attu": (0.964, 0.960),     # measured 0.9946 / 0.9900 (r5 recipe)
}

# Per-family learning-rate overrides on top of each preset's lr. r5: empty —
# the recurrent families' divergence at 3e-4 was specific to the reference
# RMSprop recipe (momentum 0.999 × doubled effective depth, BENCH_NOTES r4);
# their calibrated optimizer is now adam (ARCH_OPT), stable at the preset's
# 3e-4. The rmsprop fallback guidance (drop -l ~10x) lives in train_model's
# runtime warning and MIGRATION.md.
ARCH_LR: dict[str, float] = {}

# Per-family optimizer overrides (VERDICT r4 next #5). Measured on chip at
# the arch preset (r5, with per-step recurrent BN — models/r2u_unet.py):
#   r2u    rmsprop@3e-5 0.9185/0.8902 -> adam@3e-4 0.9970/0.9850
#   r2attu rmsprop@3e-5 0.9282/0.8905 -> adam@3e-4 0.9946/0.9900
# (val/held-out Dice). adam closes the whole family gap once the eval-mode
# BN pathology is fixed; the recurrent families now match or beat the
# attention family's held-out 0.9887.
ARCH_OPT: dict[str, str] = {
    "r2u": "adam",
    "r2attu": "adam",
}


def resolve_recipe(preset: str, arch: str, *, epochs_override: int | None = None,
                   optimizer: str | None = None, lr_override: float | None = None):
    """(floor, heldout_floor, lr, optimizer, epochs) for a demo run.

    Family floors (ARCH_FLOORS) are calibrated at the arch preset's sizing
    and gate ONLY there with the family's calibrated recipe; any off-recipe
    run (epochs/optimizer/lr override, or non-flagship arch on another
    preset) is report-only — the frozen gates never judge a configuration
    they weren't calibrated on.
    """
    h, w, n_imgs, bc, batch, lr, epochs, floor, heldout_floor = PRESETS[preset]
    if arch != "unet" or preset == "arch":
        fam = ARCH_FLOORS.get(arch) if preset == "arch" else None
        floor, heldout_floor = fam if fam is not None else (0.0, None)
        lr = ARCH_LR.get(arch, lr)
    opt = ARCH_OPT.get(arch, "rmsprop")
    if optimizer is not None and optimizer != opt:
        opt = optimizer
        floor, heldout_floor = 0.0, None
    if lr_override is not None and lr_override != lr:
        lr = lr_override
        floor, heldout_floor = 0.0, None
    if epochs_override is not None:
        epochs = epochs_override
        floor, heldout_floor = 0.0, None
    return floor, heldout_floor, lr, opt, epochs


def card(device: torch.device) -> str:
    """The GPU's name and power limit as ``nvidia-smi`` prints them, or the
    device's name off the GPU."""
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run(preset: str = "full", data_dir: str | Path | None = None,
        device_data: bool | None = None, ema_decay: float | None = None,
        augment: bool = False, augment_mode: str = "full",
        epochs_override: int | None = None, arch: str = "unet",
        optimizer: str | None = None, lr_override: float | None = None,
        kernels: str | None = None, device: str = "cuda",
        id_seed: int | None = None) -> dict:
    """One demo run; returns the JAX package's result dict. ``data_dir``
    keeps the generated data (default: a temporary directory, removed
    after), and a second run of the preset there reuses it. ``kernels`` passes to ``train_model`` ("cuda": the hand-written
    train kernels). ``device_data`` (the corpus staged on the device) and
    bf16 default to on for a GPU, as the JAX demo's do off the CPU. The run
    uses deterministic algorithms (``utils/determinism.py``), so a seeded
    run repeats bit for bit, as the JAX package's do on its TPU: the
    floors' margins were set on that premise. The datasets' ids are sorted
    (``CarvanaDataset`` keeps ``os.listdir``'s order, which differs between
    filesystems, and with it the seeded split), or with ``id_seed`` put in
    the order of that seed's permutation, another filesystem's stand-in."""
    from tpu_unet_torch.predict import resolve_device

    device = resolve_device(device)
    where = tempfile.TemporaryDirectory() if data_dir is None else contextlib.nullcontext(data_dir)
    with where as tmp, Deterministic() as det:
        result = _run(preset, Path(tmp), device, device_data, ema_decay, augment, augment_mode,
                      epochs_override, arch, optimizer, lr_override, kernels, id_seed)
    if det.reasons:
        logger.warning("ops without a deterministic form ran: %s", det.reasons)
    return result


def _run(preset, tmp, device, device_data, ema_decay, augment, augment_mode,
         epochs_override, arch, optimizer, lr_override, kernels, id_seed) -> dict:
    import tpu_unet_torch.data as data
    from tpu_unet_torch.checkpoint import load_checkpoint
    from tpu_unet_torch.data import CarvanaDataset, DataLoader, random_split_indices
    from tpu_unet_torch.data.augment import AugmentConfig
    from tpu_unet_torch.evaluate import evaluate
    from tpu_unet_torch.models import UNetConfig, init_unet
    from tpu_unet_torch.train import train_model

    h, w, n_imgs, bc, batch, _, _, _, _ = PRESETS[preset]
    floor, heldout_floor, lr, opt, epochs = resolve_recipe(
        preset, arch, epochs_override=epochs_override, optimizer=optimizer,
        lr_override=lr_override)
    gen_names = PRESET_GENS.get(preset)
    train_gen = getattr(data, gen_names[0]) if gen_names else None
    heldout_gen = getattr(data, gen_names[1]) if gen_names else data.HELDOUT_GEN
    n_held = PRESET_HELDOUT_N.get(preset, max(8, n_imgs // 8))
    # The generators are deterministic: a directory that already holds this
    # preset's data (its marker, written last, says so) is used as it is.
    marker, made = tmp / "demo_data.json", json.dumps([preset, PRESETS[preset], n_held, gen_names])
    if not (marker.exists() and marker.read_text() == made):
        data.make_synthetic_carvana(tmp / "data", n=n_imgs, h=h, w=w, gen=train_gen)
        # The held-out set: an unseen seed and unseen generator ranges.
        data.make_synthetic_carvana(tmp / "heldout", n=n_held, h=h, w=w, seed=HELDOUT_SEED,
                                    gen=heldout_gen)
        marker.write_text(made)
    ds = CarvanaDataset(tmp / "data" / "imgs", tmp / "data" / "masks", scale=1.0, cache=True)
    ds.ids = sorted(ds.ids)
    if id_seed is not None:
        ds.ids = [ds.ids[i] for i in np.random.default_rng(id_seed).permutation(len(ds.ids))]

    # The families other than the U-Net take their papers' bilinear decoder
    # (UNet++ has no other).
    config = UNetConfig(n_channels=3, n_classes=1, bilinear=(arch != "unet"),
                        base_channels=bc, arch=arch)
    params, state = init_unet(config, np.random.default_rng(0), device=device)
    on_gpu = device.type == "cuda"
    amp = on_gpu
    if device_data is None:
        device_data = on_gpu
    t0 = time.time()
    ck = tmp / "ck"
    params, state, hist = train_model(
        params, state, config, dataset=ds, epochs=epochs, batch_size=batch,
        learning_rate=lr, val_percent=1 / 6, optimizer=opt,
        # The EMA weights exist only in their sibling checkpoint files, so
        # checkpoints are written (keeping 1) when EMA is asked for.
        save_checkpoint_flag=ema_decay is not None,
        keep_checkpoints=1 if ema_decay is not None else None,
        checkpoint_dir=ck, amp=amp, seed=0, device_dataset=device_data,
        ema_decay=ema_decay, kernels=kernels,
        augment=AugmentConfig(hflip=True, brightness=0.1 if augment_mode == "full" else 0.0,
                              contrast=0.1 if augment_mode == "full" else 0.0)
        if augment else None)
    if on_gpu:
        torch.cuda.synchronize()
    wall = time.time() - t0

    _, val_idx = random_split_indices(len(ds), 1 / 6, seed=0)
    val_loader = DataLoader(ds, batch, indices=val_idx)
    dice, iou = evaluate(params, state, val_loader, config, amp=amp)
    held_ds = CarvanaDataset(tmp / "heldout" / "imgs", tmp / "heldout" / "masks", scale=1.0,
                             cache=True)
    held_ds.ids = sorted(held_ds.ids)
    held_loader = DataLoader(held_ds, batch)
    held_dice, held_iou = evaluate(params, state, held_loader, config, amp=amp)
    # Flip-ensemble TTA on the held-out set, and its hflip half alone (the
    # generator's gravity axis makes vertical flips out of distribution).
    tta_held_dice, tta_held_iou = evaluate(params, state, held_loader, config, amp=amp,
                                           tta=True)
    h_held_dice, h_held_iou = evaluate(params, state, held_loader, config, amp=amp, tta=True,
                                       tta_mode="hflip")

    ema_metrics = {}
    if ema_decay is not None:
        p_e, s_e, _, _ = load_checkpoint(ck / f"checkpoint_epoch{epochs}_ema.npz", config,
                                         device)
        e_dice, e_iou = evaluate(p_e, s_e, val_loader, config, amp=amp)
        e_h_dice, e_h_iou = evaluate(p_e, s_e, held_loader, config, amp=amp)
        ema_metrics = {
            "ema_decay": ema_decay,
            "ema_val_dice": round(float(e_dice), 4),
            "ema_val_iou": round(float(e_iou), 4),
            "ema_heldout_dice": round(float(e_h_dice), 4),
            "ema_heldout_iou": round(float(e_h_iou), 4),
        }

    passed = bool(dice >= floor)
    if heldout_floor is not None:
        passed = passed and bool(held_dice >= heldout_floor)
    return {
        "preset": preset,
        "arch": arch,
        "augment": augment,
        "augment_mode": augment_mode if augment else None,
        "heldout_seed": HELDOUT_SEED,
        "final_val_dice": round(float(dice), 4),
        "final_val_iou": round(float(iou), 4),
        "heldout_dice": round(float(held_dice), 4),
        "heldout_iou": round(float(held_iou), 4),
        "heldout_dice_tta": round(float(tta_held_dice), 4),
        "heldout_iou_tta": round(float(tta_held_iou), 4),
        "heldout_dice_tta_hflip": round(float(h_held_dice), 4),
        "heldout_iou_tta_hflip": round(float(h_held_iou), 4),
        "heldout_n": len(held_ds),
        "first_loss": round(hist["train_loss"][0], 3) if hist["train_loss"] else None,
        "last_loss": round(hist["train_loss"][-1], 3) if hist["train_loss"] else None,
        "steps": len(hist["train_loss"]),
        "lr": lr,
        "optimizer": opt,
        "epochs": epochs,
        "train_wall_s": round(wall, 1),
        "dice_floor": floor,
        "heldout_floor": heldout_floor,
        "passed": passed,
        "device": card(device),
        **ema_metrics,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", choices=list(PRESETS), default="full")
    ap.add_argument("--arch", choices=list(ARCH_FLOORS), default="unet",
                    help="Model family to train")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--ema-decay", type=float, default=None,
                    help="Also train and evaluate EMA weights; reported as ema_* fields "
                         "(the gates stay on the raw weights)")
    ap.add_argument("--augment", action="store_true", default=False,
                    help="Train with h-flip and photometric jitter on the device (report-only)")
    ap.add_argument("--augment-mode", choices=("full", "hflip"), default="full",
                    help="full = h-flip + brightness/contrast jitter; hflip = the flip alone")
    ap.add_argument("--epochs", type=int, default=None,
                    help="Override the preset's epochs (report-only: no gate)")
    ap.add_argument("--optimizer", choices=("rmsprop", "adam", "adamw", "sgd"), default=None,
                    help="Override the family's calibrated optimizer (report-only when it "
                         "differs)")
    ap.add_argument("--lr", type=float, default=None, dest="lr_override",
                    help="Override the learning rate (report-only when it differs)")
    ap.add_argument("--kernels", choices=("torch", "cuda"), default="torch",
                    help="cuda: train on the hand-written train kernels (the U-Net only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises when no GPU is present")
    ap.add_argument("--id-seed", type=int, default=None,
                    help="Order the training ids by this seed's permutation instead of "
                         "sorting them (the split's spread over filesystems' orders)")
    args = ap.parse_args(argv)
    result = run(args.preset, ema_decay=args.ema_decay, augment=args.augment,
                 augment_mode=args.augment_mode, epochs_override=args.epochs, arch=args.arch,
                 optimizer=args.optimizer, lr_override=args.lr_override,
                 kernels=None if args.kernels == "torch" else args.kernels, device=args.device,
                 id_seed=args.id_seed)
    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2))
    raise SystemExit(0 if result["passed"] else 1)


if __name__ == "__main__":
    main()
