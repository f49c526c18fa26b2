"""Eval-mode forward with BN folded into each conv's scale and bias
(``tpu_unet/models/infer.py``), for the U-Net and Attention U-Net.

``fold_bn`` turns every Conv -> BN pair into (w, scale, bias) once at load
time. ``unet_infer_apply`` then runs the U-Net through four kernels, routed
as in the JAX package's ``backend="pallas"``:

* a DoubleConv with max(Cin, Cmid) <= 256 (inc, down1, down2) is one
  ``fused_double_conv``; the others are two ``fused_conv3x3_scale_relu``;
* each decoder block's first conv is ``fused_conv3x3_concat_scale_relu`` over
  (skip, upsampled), the concat never built;
* the encoder pools after inc, down1 and down2 come from their
  ``fused_double_conv`` (``pool=True``: in bf16 its epilogue computes them),
  the one after down3 is ``max_pool2x2``;
* the ConvTranspose upsample and the 1x1 ``outc`` head are cuDNN convs, as
  the JAX package leaves them to XLA.

``backend="cuda"`` calls the kernel wrappers (which launch the CUDA kernels
for CUDA tensors); ``backend="torch"`` calls their plain PyTorch versions, the
same math with the same roundings, on any device. Attention U-Net runs on
``backend="torch"`` only, its gated skip (``_gated_skip``) before each
decoder block's first conv, as the JAX package runs it on ``"xla"`` only.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from tpu_unet_torch.models.unet import Params, Refused, State, UNetConfig, tree_map
from tpu_unet_torch.ops import conv2d, conv_transpose2d, pad_to_match, upsample2x_align_corners

BN_EPS = 1e-5
BACKENDS = ("torch", "cuda")
FOLDABLE = ("unet", "attention")


def _check_foldable(config: UNetConfig) -> None:
    if config.arch not in FOLDABLE:
        raise Refused(
            f"fold_bn/unet_infer_apply support arch='unet'/'attention', not "
            f"arch={config.arch!r}; serve/predict that family through the "
            "standard unet_apply eval path")


def check_backend(config: UNetConfig, backend: str) -> None:
    """Raise unless ``backend`` runs the folded forward of ``config.arch``,
    as the JAX package refuses it: ``fold_bn`` folds the U-Net and Attention
    U-Net only, and the hand-written kernels (``"cuda"``, JAX's Pallas tier)
    are wired for the U-Net alone."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    _check_foldable(config)
    if backend == "cuda" and config.arch != "unet":
        raise Refused("the CUDA fused-inference tier is wired for the flagship U-Net only "
                      "(the JAX package refuses its Pallas tier for attention too); use "
                      "backend='torch' (--kernels torch) for arch='attention'")


def _fold_affine(w, bn_p, bn_s):
    """One Conv (no bias) -> BN pair -> (w, scale, bias) eval affine."""
    scale = bn_p["scale"].float() * torch.rsqrt(bn_s.var + BN_EPS)
    return {"w": w, "scale": scale, "bias": bn_p["bias"].float() - bn_s.mean * scale}


def fold_bn(params: Params, state: State, config: UNetConfig) -> Params:
    """Fold BN (gamma, beta, mu, sigma^2) into per-conv (w, scale, bias), for
    the U-Net and Attention U-Net (whose gate projections ``wg``, ``wx`` and
    ``psi`` are 1x1 Conv -> BN pairs too). The other families are served
    through ``unet_apply(train=False)``, as in the JAX package."""
    _check_foldable(config)

    def fold_double_conv(p, s):
        return {f"conv{i}": _fold_affine(p[f"conv{i}"]["w"], p[f"bn{i}"], s[f"bn{i}"])
                for i in ("1", "2")}

    folded: Params = {"inc": fold_double_conv(params["inc"], state["inc"])}
    for i in range(1, 5):
        folded[f"down{i}"] = fold_double_conv(params[f"down{i}"], state[f"down{i}"])
    for i in range(1, 5):
        p, s = params[f"up{i}"], state[f"up{i}"]
        blk = {"conv": fold_double_conv(p["conv"], s["conv"])}
        if not config.bilinear:
            blk["up"] = p["up"]
        if config.arch == "attention":
            blk["att"] = {k: _fold_affine(p["att"][k]["w"], p["att"][f"bn_{bn}"],
                                          s["att"][f"bn_{bn}"])
                          for k, bn in (("wg", "g"), ("wx", "x"), ("psi", "psi"))}
        folded[f"up{i}"] = blk
    folded["outc"] = params["outc"]
    return folded


def _affine_1x1(x, cw):
    """A folded 1x1 Conv -> BN (no activation): the gate's projections."""
    h = conv2d(x, cw["w"], stride=1, padding=0)
    return (h * cw["scale"] + cw["bias"]).to(x.dtype)


def _gated_skip(skip, up, att):
    """skip * sigmoid(psi(relu(wg(up) + wx(skip)))), every projection folded."""
    a = torch.relu(_affine_1x1(up, att["wg"]) + _affine_1x1(skip, att["wx"]))
    return skip * torch.sigmoid(_affine_1x1(a, att["psi"]))


def _kernel_ops(backend: str) -> SimpleNamespace:
    if backend == "cuda":
        from tpu_unet_torch import kernels as k

        return SimpleNamespace(conv=k.fused_conv3x3_scale_relu,
                               concat_conv=k.fused_conv3x3_concat_scale_relu,
                               double_conv=k.fused_double_conv, pool=k.max_pool2x2)
    from tpu_unet_torch.kernels.fused_conv import (
        fused_conv3x3_concat_scale_relu_plain,
        fused_conv3x3_scale_relu_plain,
    )
    from tpu_unet_torch.kernels.fused_double_conv import fused_double_conv_plain
    from tpu_unet_torch.kernels.pooling import max_pool2x2_plain

    return SimpleNamespace(conv=fused_conv3x3_scale_relu_plain,
                           concat_conv=fused_conv3x3_concat_scale_relu_plain,
                           double_conv=fused_double_conv_plain, pool=max_pool2x2_plain)


def _double_conv(ops, x, p, pool: bool = False):
    """The DoubleConv's output, or with ``pool`` (output, its 2x2 max pool)."""
    from tpu_unet_torch.kernels.fused_double_conv import FUSED_DC_MAX_CHANNELS

    c1, c2 = p["conv1"], p["conv2"]
    cin, cmid = c1["w"].shape[2], c1["w"].shape[3]
    if max(cin, cmid) <= FUSED_DC_MAX_CHANNELS:
        return ops.double_conv(x, c1["w"], c1["scale"], c1["bias"],
                               c2["w"], c2["scale"], c2["bias"], pool=pool)
    h = ops.conv(x, c1["w"], c1["scale"], c1["bias"])
    y = ops.conv(h, c2["w"], c2["scale"], c2["bias"])
    return (y, ops.pool(y)) if pool else y


def unet_infer_apply(folded: Params, x: torch.Tensor, *, config: UNetConfig,
                     backend: str = "cuda", compute_dtype: torch.dtype | None = None
                     ) -> torch.Tensor:
    """Eval-mode forward on folded params. x: [N,H,W,C] -> fp32 logits
    [N,H,W,n_classes]. ``compute_dtype=torch.bfloat16`` casts the input and
    every folded parameter (scale and bias included) to bf16 first, as the
    JAX forward does; the kernels then accumulate in fp32."""
    check_backend(config, backend)
    ops = _kernel_ops(backend)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        folded = tree_map(lambda t: t.to(compute_dtype), folded)
    x = x.contiguous()

    x1, h = _double_conv(ops, x, folded["inc"], pool=True)
    x2, h = _double_conv(ops, h, folded["down1"], pool=True)
    x3, h = _double_conv(ops, h, folded["down2"], pool=True)
    x4 = _double_conv(ops, h, folded["down3"])
    x5 = _double_conv(ops, ops.pool(x4), folded["down4"])

    h = x5
    for i, skip in zip(range(1, 5), (x4, x3, x2, x1)):
        blk = folded[f"up{i}"]
        if config.bilinear:
            up = upsample2x_align_corners(h)
        else:
            up = conv_transpose2d(h, blk["up"]["w"], stride=2)
            up = (up.float() + blk["up"]["b"].float()).to(h.dtype)
        up = pad_to_match(up, skip)
        if config.arch == "attention":
            skip = _gated_skip(skip, up, blk["att"])
        c1, c2 = blk["conv"]["conv1"], blk["conv"]["conv2"]
        h = ops.concat_conv(skip, up, c1["w"], c1["scale"], c1["bias"])
        h = ops.conv(h, c2["w"], c2["scale"], c2["bias"])

    logits = conv2d(h, folded["outc"]["w"], stride=1, padding=0)
    return logits.float() + folded["outc"]["b"].float()
