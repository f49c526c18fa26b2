"""Model-hub entry points (``tpu_unet/hub.py``): ``unet_carvana`` as the
reference's ``torch.hub.load(..., 'unet_carvana', pretrained=True,
scale=0.5)`` names it, and ``unet`` over every model family. Both return
``(params, state, config, mask_values)``, the port's model handle, on
``device``.

There is no download: ``pretrained=True`` takes a local weights file
(``weights_path=`` or ``TPU_UNET_WEIGHTS``), either a ``.npz`` checkpoint or
the reference's released ``.pth`` (``checkpoint.import_pth``). Fresh trees
come from ``init_unet`` with a seeded numpy generator; they are not the JAX
package's ``PRNGKey(0)`` draws. ``hubconf.py`` beside this module is the
``torch.hub`` entry file.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from tpu_unet_torch.models import UNetConfig, init_unet
from tpu_unet_torch.predict import resolve_device

logger = logging.getLogger(__name__)

# The upstream's released Carvana checkpoints, by input scale.
_RELEASE_FILES = {
    0.5: "unet_carvana_scale0.5_epoch2.pth",
    1.0: "unet_carvana_scale1.0_epoch2.pth",
}


def unet_carvana(pretrained: bool = False, scale: float = 0.5, weights_path: str | None = None,
                 device="cuda"):
    """The Carvana U-Net (3 channels in, 2 classes, ConvTranspose decoder):
    fresh weights, or with ``pretrained`` those of ``weights_path`` (or env
    ``TPU_UNET_WEIGHTS``), a ``.pth`` or a ``.npz`` of this config."""
    from tpu_unet_torch.checkpoint import import_pth, load_checkpoint

    device = resolve_device(device)
    config = UNetConfig(n_channels=3, n_classes=2, bilinear=False)
    if not pretrained:
        params, state = init_unet(config, np.random.default_rng(0), device=device)
        return params, state, config, None
    path = weights_path or os.environ.get("TPU_UNET_WEIGHTS")
    if not path:
        raise RuntimeError(
            "pretrained=True needs a local weights file (there is no download): pass "
            "weights_path= or set TPU_UNET_WEIGHTS. Upstream release file: "
            f"{_RELEASE_FILES.get(scale)}")
    if str(path).endswith(".pth"):
        params, state, mask_values = import_pth(path, config, device)
    else:
        params, state, mask_values, _ = load_checkpoint(path, config, device)
    return params, state, config, mask_values


def unet(arch: str = "unet", n_channels: int = 3, n_classes: int = 2,
         bilinear: bool | None = None, base_channels: int = 64, recur_t: int = 2,
         weights_path: str | None = None, device="cuda"):
    """Any family (``arch``: unet | unetpp | attention | r2u | r2attu).
    ``bilinear`` None picks each family's decoder: ConvTranspose for the
    U-Net, bilinear for the others. ``weights_path``: a ``.pth`` (the U-Net
    only: the families have no torch release) or a ``.npz``, whose stored
    config wins over the arguments (logged)."""
    from tpu_unet_torch.checkpoint import import_pth, load_checkpoint, read_checkpoint_meta

    device = resolve_device(device)
    if bilinear is None:
        bilinear = arch != "unet"
    config = UNetConfig(n_channels=n_channels, n_classes=n_classes, bilinear=bilinear,
                        base_channels=base_channels, arch=arch, recur_t=recur_t)
    if not weights_path:
        params, state = init_unet(config, np.random.default_rng(0), device=device)
        return params, state, config, None
    if str(weights_path).endswith(".pth"):
        params, state, mask_values = import_pth(weights_path, config, device)
        return params, state, config, mask_values
    # A .npz describes itself: its config acts over the caller's arguments,
    # which are defaults, not overrides.
    _, extra = read_checkpoint_meta(weights_path)
    if "config" in extra:
        file_config = UNetConfig(**{"recur_bn": "shared", **extra["config"]})
        if file_config != config:
            logger.info("hub.unet: checkpoint is %s — using its config over the caller's %s",
                        file_config, config)
            config = file_config
    params, state, mask_values, _ = load_checkpoint(weights_path, config, device)
    return params, state, config, mask_values
