"""R2AttU-Net: R2U-Net's recurrent residual blocks with Attention U-Net's
gated skips (Alom et al., arXiv:1802.06955 §3, with the additive gate of
Oktay et al., arXiv:1804.03999; ``tpu_unet/models/r2attu_unet.py``).

Pure composition: the RRCNN block comes from ``models/r2u_unet.py`` and the
gate from ``models/attention_unet.py``; only the decoder wiring (upsample,
gate the skip, concat [gated, up], RRCNN) is this module's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_unet_torch.models.attention_unet import _gate_init, gated_up_apply
from tpu_unet_torch.models.r2u_unet import _rrcnn_apply, init_r2u_unet
from tpu_unet_torch.models.unet import Params, State, UNetConfig, encoder_decoder


def init_r2attu_unet(config: UNetConfig, rng: np.random.Generator,
                     device="cpu") -> tuple[Params, State]:
    """The U-Net's channel plan, RRCNN blocks and one gate per skip."""
    return init_r2u_unet(config, rng, device, gate_init=_gate_init)


def r2attu_unet_apply(params: Params, state: State, x: torch.Tensor, *, config: UNetConfig,
                      train: bool = False, remat: bool = False, group=None
                      ) -> tuple[torch.Tensor, State]:
    """Forward on params already in the compute dtype (``unet_apply`` casts
    them): [N,H,W,C] -> (fp32 logits, new BN state); ``group``: BN over
    every rank (``unet_apply``)."""
    rr = functools.partial(_rrcnn_apply, t=config.recur_t, train=train)
    up = functools.partial(gated_up_apply, bilinear=config.bilinear, train=train, block=rr)
    return encoder_decoder(params, state, x, block=rr, up=up, remat=remat, group=group)
