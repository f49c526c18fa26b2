"""The plain reference: the U-Net (Ronneberger et al. 2015, as in
milesial/Pytorch-UNet's ``UNet(3, 1, bilinear=False)``) and Attention U-Net
(Oktay et al. 2018) in plain PyTorch on NCHW tensors, float32 with TF32
off, with the Carvana recipe: BCE-with-logits + Dice (the batch reduced
first, eps 1e-6), global-norm clipping at 1.0 and ``torch.optim.RMSprop``
(alpha 0.99, eps 1e-8, weight decay 1e-8, momentum 0.999).

It imports nothing of the program and takes nothing the program made: it
reads the benchmark's own weights and inputs (``inputs.py``) and works out
everything the program derives from them, the folded BN included (here
BN is applied, not folded).

Departures from the published models, as the program's configuration
states them: the attention gates' 1x1 convs carry no bias (BN follows each),
and F_int is half the skip's channels.

``Quant`` computes the convs in a lower precision for the control (step 2
of how ``correct`` is decided): fp8 e4m3 inputs and weights with one scale
a tensor, and e5m2 gradients in the backward pass.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from port_bench.inputs import initial_bn_state

BN_EPS = 1e-5
ALPHA = 0.99  # RMSprop's square-average decay


class _GradQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


def _fp8(t: torch.Tensor, dtype, fmax: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one scale, its gradient passed
    straight through (the cast to fp8 has none)."""
    d = t.detach()
    scale = d.abs().amax().float().clamp(min=1e-30) / fmax
    return t + ((d / scale).to(dtype).to(t.dtype) * scale - d)


class Quant:
    """fp8 convs: e4m3 activations and weights forward, e5m2 gradients."""

    def inputs(self, *ts):
        return [_fp8(t, torch.float8_e4m3fn, 448.0) for t in ts]

    def output(self, y):
        return _GradQuant.apply(y)


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 on or off for float32 convs and matmuls, restored after."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


class Model:
    """The forward over a flat ``{path: tensor}`` of HWIO weights and BN
    statistics ``{path/mean, path/var}``, updated in place in train mode."""

    def __init__(self, config: dict, quant: Quant | None = None, bn_momentum: float = 0.1):
        self.config, self.quant, self.momentum = config, quant, bn_momentum

    def _conv(self, x, w, padding):
        w = w.permute(3, 2, 0, 1)
        if self.quant:
            x, w = self.quant.inputs(x, w)
        y = F.conv2d(x, w, padding=padding)
        return self.quant.output(y) if self.quant else y

    def _convt(self, x, w, b):
        w = w.permute(2, 3, 0, 1)
        if self.quant:
            x, w = self.quant.inputs(x, w)
        y = F.conv_transpose2d(x, w, stride=2)
        y = self.quant.output(y) if self.quant else y
        return y + b.view(1, -1, 1, 1)

    def _bn(self, x, p, path, state, train):
        return F.batch_norm(x, state[f"{path}/mean"], state[f"{path}/var"], p[f"{path}/scale"],
                            p[f"{path}/bias"], training=train, momentum=self.momentum,
                            eps=BN_EPS)

    def _double_conv(self, x, p, path, state, train):
        for i in ("1", "2"):
            x = self._conv(x, p[f"{path}/conv{i}/w"], 1)
            x = torch.relu(self._bn(x, p, f"{path}/bn{i}", state, train))
        return x

    def _gate(self, g, x, p, path, state, train):
        hg = self._bn(self._conv(g, p[f"{path}/wg/w"], 0), p, f"{path}/bn_g", state, train)
        hx = self._bn(self._conv(x, p[f"{path}/wx/w"], 0), p, f"{path}/bn_x", state, train)
        a = self._bn(self._conv(torch.relu(hg + hx), p[f"{path}/psi/w"], 0), p, f"{path}/bn_psi",
                     state, train)
        return x * torch.sigmoid(a)

    def __call__(self, p: dict, state: dict, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        """x: [N,3,H,W] float32 -> logits [N,n_classes,H,W]."""
        skips = []
        h = self._double_conv(x, p, "inc", state, train)
        for i in range(1, 5):
            skips.append(h)
            h = self._double_conv(F.max_pool2d(h, 2), p, f"down{i}", state, train)
        for i, skip in zip(range(1, 5), reversed(skips)):
            up = self._convt(h, p[f"up{i}/up/w"], p[f"up{i}/up/b"])
            dy, dx = skip.shape[2] - up.shape[2], skip.shape[3] - up.shape[3]
            up = F.pad(up, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
            if self.config["arch"] == "attention":
                skip = self._gate(up, skip, p, f"up{i}/att", state, train)
            h = self._double_conv(torch.cat([skip, up], 1), p, f"up{i}/conv", state, train)
        return self._conv(h, p["outc/w"], 0) + p["outc/b"].view(1, -1, 1, 1)


def dice_loss(prob: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """1 - Dice over the whole batch at once (milesial's ``dice_loss`` with
    ``reduce_batch_first``): two empty masks score 1."""
    inter = 2 * (prob * target).sum()
    sets = prob.sum() + target.sum()
    sets = torch.where(sets == 0, inter, sets)
    return 1 - (inter + eps) / (sets + eps)


def criterion(logits: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits + Dice on the one class, milesial's train loop."""
    z = logits.squeeze(1)
    m = masks.float()
    return F.binary_cross_entropy_with_logits(z, m) + dice_loss(torch.sigmoid(z), m)


def nchw(images: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] -> [N,C,H,W] float32."""
    return images.permute(0, 3, 1, 2).float().contiguous()


def norms(tensors) -> list[float]:
    """The L2 norm of each tensor, in fp32 (the difference of two fp32
    params is exact), fetched in one copy."""
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()


def grad_norms(square_avgs) -> list[float]:
    """Each leaf's gradient norm as RMSprop took it at its first step, from
    its square average then, (1 − alpha)·g²."""
    return torch.stack([s.float().sum() for s in square_avgs]).div(1 - ALPHA).sqrt().tolist()


def train_steps(config: dict, weights: dict, bn_state: dict, batches, *, lr: float,
                quant: Quant | None = None, half_batch: bool = False) -> dict:
    """The recipe's first ``len(batches)`` steps from ``weights``: each
    step's loss, each leaf's first gradient as RMSprop takes it (clipped,
    weight decay added: sqrt(square_avg / (1 - alpha)) after step 1), and
    each leaf's change after the last step, as float64 norms by path.
    ``half_batch`` is the fault that leaves half of each batch out."""
    model = Model(config, quant)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    state = {k: v.detach().clone() for k, v in bn_state.items()}
    opt = torch.optim.RMSprop(list(params.values()), lr=lr, alpha=ALPHA, eps=1e-8,
                              weight_decay=1e-8, momentum=0.999)
    losses, grad, step_s = [], {}, []
    for k, (images, masks) in enumerate(batches):
        t0 = time.perf_counter()
        if half_batch:
            images, masks = images[: len(images) // 2], masks[: len(masks) // 2]
        opt.zero_grad(set_to_none=True)
        loss = criterion(model(params, state, nchw(images), train=True), masks)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(params.values()), 1.0)
        opt.step()
        losses.append(float(loss.detach()))
        step_s.append(time.perf_counter() - t0)
        if k == 0:
            grad = dict(zip(params, grad_norms([opt.state[p]["square_avg"]
                                                for p in params.values()])))
    change = dict(zip(params, norms([p.detach() - weights[n] for n, p in params.items()])))
    return {"loss": losses, "grad": grad, "change": change, "step_s": step_s}


def eval_logits(config: dict, weights: dict, bn_state: dict, images: torch.Tensor, *,
                quant: Quant | None = None) -> torch.Tensor:
    """Eval-mode logits [N,1,H,W] of fp32 images [N,H,W,3]."""
    with torch.no_grad():
        return Model(config, quant)(weights, bn_state, nchw(images), train=False)


def calibrated_bn_state(config: dict, weights: dict, images: torch.Tensor) -> dict:
    """Running statistics taken from one train-mode pass over ``images``
    (momentum 1: the batch's mean and unbiased variance), so that an
    eval-mode forward sees normalised activations, as a trained model's
    statistics give it."""
    state = initial_bn_state(config, images.device)
    with torch.no_grad():
        Model(config, bn_momentum=1.0)(weights, state, nchw(images), train=True)
    return state


def served_logits(cfg, weights, bn, images, idxs, dev, H, W, h, w, quant=None):
    """The reference's full-size logits of ``images[idx]``: the host
    preprocess (PIL BICUBIC to the scaled size, /255), the eval forward in
    fp32, the half-pixel bilinear upscale to the image's size."""
    arr = np.stack([np.asarray(images[i].resize((w, h), resample=Image.BICUBIC)) for i in idxs])
    x = torch.from_numpy(arr).to(dev).float() / 255.0
    with precision(tf32=False):
        z = eval_logits(cfg["model"], weights, bn, x, quant=quant)
        return F.interpolate(z, size=(H, W), mode="bilinear", align_corners=False)[:, 0]
