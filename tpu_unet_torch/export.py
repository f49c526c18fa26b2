"""Ahead-of-time export (``tpu_unet/export.py``): the BN-folded eval forward
as a ``.pt2`` artifact through ``torch.export``.

The JAX package lowers ``fold_bn`` + ``unet_infer_apply`` to StableHLO with
the weights baked in, so a serving site runs the model with no model code
and no checkpoint. The port exports the same forward as a
``torch.export.ExportedProgram``, the folded weights lifted as constants: a
site loads it (``load_exported``) and calls ``ep.module()(x)`` with an
``[N, H, W, C]`` float32 batch, getting fp32 logits ``[N, H, W, classes]``.

* The forward is ``backend="torch"`` (cuDNN convs), the counterpart of the
  JAX package's XLA-only export: no hand-written kernel sits inside the
  program, as no Pallas custom call sits inside JAX's, because one would
  need the compiled extension at every load site.
* The batch is symbolic by default (a ``torch.export.Dim``; the example
  batch is 2, since torch.export specializes sizes 0 and 1); ``batch``
  pins it. H and W are static.
* A torch program is placed at load (``load_exported(device=)``), so one
  file serves on ``cuda`` and on a CPU canary, where JAX lowers for both
  platforms.
* ``tta`` bakes the flip ensemble into the program.
* ``save_exported`` writes a ``<path>.meta.json`` sidecar with JAX's keys:
  ``mask_values``, ``config``, ``tta``, ``tta_mode``.

``.jaxexp`` (StableHLO, loadable only by ``jax``) and ``.savedmodel``
(TensorFlow through ``jax2tf``) are refused by name.

CLI:
    python -m tpu_unet_torch.export -m ckpt.npz -o model.pt2 --height 640 --width 959 \
        [--batch N] [--no-amp] [--tta [--tta-mode hflip]] [--check] [--device cuda|cpu]
    python -m tpu_unet_torch.export -m ckpt.npz -o model.pth [--check]   # torch state dict
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from tpu_unet_torch.models import UNetConfig, fold_bn, unet_infer_apply
from tpu_unet_torch.models.tta import TTA_MODES, tta_merge, tta_views
from tpu_unet_torch.models.unet import tree_map
from tpu_unet_torch.predict import exit_on_refusal, load_model, resolve_device

logger = logging.getLogger(__name__)

# --check's bound on |reloaded - live| logits: JAX's fp32 atol. The bf16
# program runs the live forward's ops on the same inputs, so it is held to
# the same bound: max |diff| 0 in both dtypes on the CPU and on an H100
# (chip_smoke.py phase 15, 640x959, batch 1 and 4).
CHECK_ATOL = 1e-5


class FoldedForward(torch.nn.Module):
    """The folded eval forward on ``backend="torch"`` (``tta``: the flip
    views as one batch, merged) as a module for ``torch.export``; the folded
    weights are plain tensor attributes, lifted as constants."""

    def __init__(self, folded, config: UNetConfig, *, compute_dtype=None, tta: bool = False,
                 tta_mode: str = "flips"):
        super().__init__()
        self.folded, self.config = folded, config
        self.compute_dtype, self.tta, self.tta_mode = compute_dtype, tta, tta_mode

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return unet_infer_apply(self.folded, x, config=self.config, backend="torch",
                                compute_dtype=self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tta:
            return self._logits(x)
        return tta_merge(self._logits(tta_views(x, self.tta_mode)), x.shape[0], self.tta_mode)


def folded_forward(params, state, config: UNetConfig, *, amp: bool = True, tta: bool = False,
                   tta_mode: str = "flips", device="cuda") -> FoldedForward:
    """The live module that ``export_infer`` exports: ``fold_bn`` of the trees,
    on ``device``, cast once to bf16 under ``amp`` (as the server keeps them)."""
    compute_dtype = torch.bfloat16 if amp else None
    folded = tree_map(lambda t: t.to(device, compute_dtype or torch.float32),
                      fold_bn(params, state, config))
    return FoldedForward(folded, config, compute_dtype=compute_dtype, tta=tta, tta_mode=tta_mode)


def export_infer(params, state, config: UNetConfig, *, height: int, width: int,
                 batch: int | None = None, amp: bool = True, tta: bool = False,
                 tta_mode: str = "flips", device="cuda") -> torch.export.ExportedProgram:
    """Export the BN-folded eval forward (module docstring) for
    ``[batch, height, width, n_channels]`` float32 inputs on ``device``;
    ``batch=None`` makes the batch a symbolic dimension. Families that
    ``fold_bn`` refuses stay refused."""
    device = resolve_device(device)
    module = folded_forward(params, state, config, amp=amp, tta=tta, tta_mode=tta_mode,
                            device=device)
    x = torch.zeros((batch or 2, height, width, config.n_channels), device=device)
    dynamic = None if batch else ({0: torch.export.Dim("b", min=1)},)
    return torch.export.export(module, (x,), dynamic_shapes=dynamic)


def program_shapes(ep: torch.export.ExportedProgram) -> tuple[int | None, int, int, int]:
    """(batch, H, W, n_classes) of the program: batch None when symbolic."""
    nodes = {n.name: n for n in ep.graph.nodes}
    (x_name,) = ep.graph_signature.user_inputs
    (y_name,) = ep.graph_signature.user_outputs
    b, h, w, _ = nodes[x_name].meta["val"].shape
    return (b if isinstance(b, int) else None), int(h), int(w), int(
        nodes[y_name].meta["val"].shape[-1])


def save_exported(ep: torch.export.ExportedProgram, path: str | Path,
                  meta: dict | None = None) -> None:
    """Write the program (``torch.export.save``) and, with ``meta``, the
    ``<path>.meta.json`` sidecar: what a serving site needs besides the
    program, the palette and the config."""
    torch.export.save(ep, str(path))
    if meta is not None:
        Path(str(path) + ".meta.json").write_text(json.dumps(meta))


def load_exported(path: str | Path, device="cuda") -> torch.export.ExportedProgram:
    """The program of a ``.pt2`` on ``device``: its lifted constants, its
    state and any device argument in its graph moved there
    (``torch.export.passes.move_to_device_pass``), its convs under
    ``ops.conv.cudnn_engine_rule``. Raises if a tensor of the program stays
    elsewhere."""
    from torch.export.passes import move_to_device_pass

    from tpu_unet_torch.ops.conv import cudnn_engine_rule

    cudnn_engine_rule()  # the program's convs are the port's library convs
    device = resolve_device(device)
    ep = move_to_device_pass(torch.export.load(str(path)), device)
    stray = sorted(name for name, t in (*ep.constants.items(), *ep.state_dict.items())
                   if isinstance(t, torch.Tensor) and t.device.type != device.type)
    if stray:
        raise RuntimeError(f"{path}: {len(stray)} tensors of the program stay off {device} "
                           f"after the move, e.g. {stray[:3]}")
    return ep


def load_artifact_meta(path: str | Path) -> dict:
    """The ``<path>.meta.json`` sidecar ({} when there is none)."""
    p = Path(str(path) + ".meta.json")
    return json.loads(p.read_text()) if p.exists() else {}


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Export the model as a torch.export .pt2 artifact "
                                            "(PyTorch port)")
    p.add_argument("--model", "-m", required=True, help="Checkpoint (.npz or .pth)")
    p.add_argument("--output", "-o", required=True,
                   help="Output: a .pt2 program (torch.export) or a .pth state dict")
    p.add_argument("--height", type=int, default=None,
                   help="Static input height (required for .pt2 output)")
    p.add_argument("--width", type=int, default=None,
                   help="Static input width (required for .pt2 output)")
    p.add_argument("--batch", type=int, default=None,
                   help="Pin the batch dim (default: symbolic, any batch)")
    p.add_argument("--no-amp", dest="amp", action="store_false", default=True,
                   help="Compute in fp32 instead of bf16")
    p.add_argument("--platforms", type=str, default=None,
                   help="Refused: a torch program is placed at load (load_exported(device=)), "
                        "not lowered per platform")
    p.add_argument("--tta", action="store_true", default=False,
                   help="Bake the flip-view ensemble into the program")
    p.add_argument("--tta-mode", choices=tuple(TTA_MODES), default="flips",
                   help="TTA views to bake: all four flips, or identity + left-right only")
    p.add_argument("--check", action="store_true", default=False,
                   help="Reload the artifact and hold it against the live model")
    p.add_argument("--classes", "-c", type=int, default=1)
    p.add_argument("--bilinear", action="store_true", default=False)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' raises when no GPU is present")
    return p.parse_args(argv)


def _refuse(args) -> None:
    out = str(args.output)
    if out.endswith(".jaxexp"):
        raise SystemExit(f"{out}: a .jaxexp is a StableHLO program that only jax loads; "
                         "export a .pt2 (torch.export) instead")
    if out.endswith(".savedmodel"):
        raise SystemExit(f"{out}: a SavedModel needs TensorFlow with jax2tf; export a .pt2 "
                         "(torch.export) instead")
    if args.platforms is not None:
        raise SystemExit("--platforms: a torch program is placed at load "
                         "(load_exported(device=)), not lowered per platform")


def _check_pth(args, params, state, config, mask_values) -> None:
    from tpu_unet_torch.checkpoint import flatten, import_pth

    p2, s2, mv2 = import_pth(args.output, config)
    want, got = flatten(params, state), flatten(p2, s2)
    if want.keys() != got.keys() or any(not np.array_equal(want[k], got[k]) for k in want):
        raise SystemExit(f"{args.output}: round-trip check failed (a tensor differs)")
    if mask_values is not None and list(mv2) != list(mask_values):
        raise SystemExit(f"{args.output}: round-trip check failed (palette {mv2} != "
                         f"{mask_values})")
    logger.info("Round-trip check OK (bitwise)")


def _check_program(args, params, state, config, device) -> float:
    """Hold the reloaded program against the live folded forward on a seeded
    batch; returns the max |diff|."""
    reloaded = load_exported(args.output, device).module()
    x = torch.from_numpy(np.random.default_rng(0).random(
        (args.batch or 2, args.height, args.width, config.n_channels), dtype=np.float32))
    live = folded_forward(params, state, config, amp=args.amp, tta=args.tta,
                          tta_mode=args.tta_mode, device=device)
    with torch.inference_mode():
        got, want = reloaded(x.to(device)), live(x.to(device))
    err = (got - want).abs().max().item()
    if not err <= CHECK_ATOL:
        raise SystemExit(f"{args.output}: round-trip check failed, max |diff| {err:.3e} > "
                         f"{CHECK_ATOL:.0e}")
    logger.info("Round-trip check OK (max |diff| = %.2e)", err)
    return err


@exit_on_refusal("tpu_unet_torch.export")
def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    args = get_args(argv)
    _refuse(args)
    device = resolve_device(args.device)
    config = UNetConfig(n_channels=3, n_classes=args.classes, bilinear=args.bilinear)
    params, state, config, mask_values = load_model(args.model, config, device)
    if str(args.output).endswith(".pth"):
        # The other direction of torch interop: a state dict the reference
        # loads directly.
        from tpu_unet_torch.checkpoint import export_pth

        export_pth(args.output, params, state, config, mask_values=mask_values)
        logger.info("Exported %s -> %s (torch state_dict, %.1f MB)", args.model, args.output,
                    Path(args.output).stat().st_size / 1e6)
        if args.check:
            _check_pth(args, params, state, config, mask_values)
        return
    if args.height is None or args.width is None:
        raise SystemExit("--height/--width are required for .pt2 export")
    t0 = time.perf_counter()
    ep = export_infer(params, state, config, height=args.height, width=args.width,
                      batch=args.batch, amp=args.amp, tta=args.tta, tta_mode=args.tta_mode,
                      device=device)
    save_exported(ep, args.output, meta={"mask_values": mask_values, "config": config._asdict(),
                                         "tta": args.tta, "tta_mode": args.tta_mode})
    logger.info("Exported %s -> %s in %.1f s (%.1f MB, device=%s, batch=%s, %dx%d)", args.model,
                args.output, time.perf_counter() - t0, Path(args.output).stat().st_size / 1e6,
                device, args.batch or "symbolic", args.height, args.width)
    if args.check:
        _check_program(args, params, state, config, device)


if __name__ == "__main__":
    main()
