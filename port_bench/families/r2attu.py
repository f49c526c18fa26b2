"""R2AttU-Net for the benchmark: its layout, weights and BN statistics, its
plain reference and train steps, and its FLOP and byte counts.

The model is the recurrent residual U-Net of Alom et al. (arXiv:1802.06955)
with the additive attention gate of Oktay et al. (arXiv:1804.03999), as
LeeJunHyun/Image_Segmentation implements it (``network.py::R2AttU_Net(img_ch=3,
output_ch=1, t=2)``): widths 64 to 1024, every DoubleConv of the U-Net
replaced by an RRCNN block

    x   = conv1x1(x_in) + b      # the channel-setting projection
    h   = rec2(rec1(x))          # two recurrent units
    out = x + h

where a recurrent unit applies one weight-shared 3x3 conv -> BN -> ReLU t+1
times, feeding the block's input in again each time: h = unit(x), then t
times h = unit(x + h). Each decoder level gates its skip x by the upsampled
g before the concatenation [gated skip, g]:
x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x))))), F_int half the skip's
channels.

Departures from LeeJunHyun's ``R2AttU_Net``, as the configuration states
them (``configs/r2attu_carvana.json``):

- the decoder upsamples by a 2x2 stride-2 ConvTranspose with bias (the
  U-Net's), where the source uses Upsample + 3x3 conv + BN + ReLU;
- the 3x3 convs of the recurrent units and the gate's 1x1 convs carry no
  bias (a BN follows each);
- each of a unit's t+1 applications keeps its own running statistics
  (``recur_bn="per_step"``), where the source steps one shared
  ``BatchNorm2d`` t+1 times; γ and β are shared either way, and in train
  mode the normalisation (by the batch's statistics) is the same.

The reference runs NCHW, float32 with TF32 off (the caller's
``reference.precision``), ``torch.nn.functional`` ops only, and takes
nothing from the program: it reads the benchmark's weights by path.
"""

from __future__ import annotations

import math
import time

import torch
import torch.nn.functional as F

from port_bench import reference, yardstick
from port_bench.reference import BN_EPS, Quant

ARCH = "r2attu"


def _check(config: dict) -> None:
    if config["arch"] != ARCH or config.get("bilinear"):
        raise ValueError(f"families/r2attu.py: arch 'r2attu' with the ConvTranspose decoder, "
                         f"not {config['arch']!r} (bilinear {config.get('bilinear')})")
    if config.get("recur_bn", "per_step") != "per_step":
        raise ValueError("families/r2attu.py: per-application BN statistics "
                         "(recur_bn 'per_step') only")


def _plan(config: dict):
    """(encoder (cin, cout) pairs, decoder (skip, cin, g_ch) triples)."""
    c = config["base_channels"]
    enc = [(config["n_channels"], c), (c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c),
           (8 * c, 16 * c)]
    dec = [(8 * c // 2 ** (i - 1), 16 * c // 2 ** (i - 1), 8 * c // 2 ** (i - 1))
           for i in range(1, 5)]
    return enc, dec


def _rrcnn(prefix: str, cin: int, cout: int) -> list:
    out = [(f"{prefix}/proj/w", (1, 1, cin, cout), cin), (f"{prefix}/proj/b", (cout,), cin)]
    for unit in ("rec1", "rec2"):
        out += [(f"{prefix}/{unit}/conv/w", (3, 3, cout, cout), cout * 9),
                (f"{prefix}/{unit}/bn/scale", (cout,), "one"),
                (f"{prefix}/{unit}/bn/bias", (cout,), "zero")]
    return out


def _gate(prefix: str, g_ch: int, skip: int) -> list:
    f = max(1, skip // 2)
    return [(f"{prefix}/wg/w", (1, 1, g_ch, f), g_ch), (f"{prefix}/bn_g/scale", (f,), "one"),
            (f"{prefix}/bn_g/bias", (f,), "zero"),
            (f"{prefix}/wx/w", (1, 1, skip, f), skip), (f"{prefix}/bn_x/scale", (f,), "one"),
            (f"{prefix}/bn_x/bias", (f,), "zero"),
            (f"{prefix}/psi/w", (1, 1, f, 1), f), (f"{prefix}/bn_psi/scale", (1,), "one"),
            (f"{prefix}/bn_psi/bias", (1,), "zero")]


def layout(config: dict) -> list[tuple[str, tuple, object]]:
    """(path, shape, init) of every parameter in the program's order and
    paths, init a fan-in (uniform draw, torch's default bound; a
    ConvTranspose's fan-in is Cout·k·k) or "one" / "zero"."""
    _check(config)
    enc, dec = _plan(config)
    out = []
    for i, (cin, cout) in enumerate(enc):
        out += _rrcnn("inc" if i == 0 else f"down{i}", cin, cout)
    for i, (skip, cin, g_ch) in enumerate(dec, start=1):
        p = f"up{i}"
        out += [(f"{p}/up/w", (2, 2, cin, g_ch), g_ch * 4), (f"{p}/up/b", (g_ch,), g_ch * 4)]
        out += _rrcnn(f"{p}/conv", skip + g_ch, skip)
        out += _gate(f"{p}/att", g_ch, skip)
    n = config["n_classes"]
    c = config["base_channels"]
    out += [("outc/w", (1, 1, c, n), c), ("outc/b", (n,), c)]
    return out


def bn_layers(config: dict) -> list[tuple[str, int]]:
    """(path, channels) of every set of running statistics, in the
    program's order: ``<block>/rec1/bn0`` .. ``bn<t>`` a recurrent unit,
    ``up<i>/att/bn_g``, ``bn_x``, ``bn_psi`` a gate."""
    _check(config)
    t = config["recur_t"]
    out = []
    for path, shape, _ in layout(config):
        if path.endswith("/bn/scale"):  # a recurrent unit: t + 1 sets
            unit = path[: -len("/bn/scale")]
            out += [(f"{unit}/bn{i}", shape[0]) for i in range(t + 1)]
        elif path.endswith("/scale"):
            out.append((path[: -len("/scale")], shape[0]))
    return out


def make_weights(config: dict, g: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Every parameter as fp32 on ``device``, drawn as ``inputs.make_weights``
    draws the U-Net's: one uniform draw for all the drawn leaves in layout
    order, split and scaled by each leaf's bound."""
    leaves = layout(config)
    total = sum(math.prod(s) for _, s, init in leaves if not isinstance(init, str))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for p, s, init in leaves:
        if init == "one":
            out[p] = torch.ones(s, device=device)
        elif init == "zero":
            out[p] = torch.zeros(s, device=device)
        else:
            n = math.prod(s)
            out[p] = (u[off:off + n].view(s) * 2 - 1) * (1.0 / math.sqrt(init))
            off += n
    return out


def initial_bn_state(config: dict, device) -> dict[str, torch.Tensor]:
    """Running statistics at the start of training: mean 0, variance 1."""
    out = {}
    for p, ch in bn_layers(config):
        out[f"{p}/mean"] = torch.zeros(ch, device=device)
        out[f"{p}/var"] = torch.ones(ch, device=device)
    return out


class Model(reference.Model):
    """R2AttU-Net's forward over a flat ``{path: tensor}`` of HWIO weights and
    BN statistics ``{path/mean, path/var}``, updated in place in train mode
    (each recurrent application its own ``bn<i>``). The module docstring
    lists the departures from LeeJunHyun's ``R2AttU_Net``."""

    def _rec(self, x, p, path, state, train):
        """One recurrent unit: h = relu(BN_0(conv(x))), then for i = 1..t
        h = relu(BN_i(conv(x + h))), the conv and γ, β shared."""
        w, h = p[f"{path}/conv/w"], None
        for i in range(self.config["recur_t"] + 1):
            y = self._conv(x if h is None else x + h, w, 1)
            stats = state[f"{path}/bn{i}/mean"], state[f"{path}/bn{i}/var"]
            h = torch.relu(F.batch_norm(y, *stats, p[f"{path}/bn/scale"], p[f"{path}/bn/bias"],
                                        training=train, momentum=self.momentum, eps=BN_EPS))
        return h

    def _rrcnn(self, x, p, path, state, train):
        x = self._conv(x, p[f"{path}/proj/w"], 0) + p[f"{path}/proj/b"].view(1, -1, 1, 1)
        h = self._rec(x, p, f"{path}/rec1", state, train)
        h = self._rec(h, p, f"{path}/rec2", state, train)
        return x + h

    def __call__(self, p: dict, state: dict, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        """x: [N,3,H,W] float32 -> logits [N,n_classes,H,W]."""
        skips = []
        h = self._rrcnn(x, p, "inc", state, train)
        for i in range(1, 5):
            skips.append(h)
            h = self._rrcnn(F.max_pool2d(h, 2), p, f"down{i}", state, train)
        for i, skip in zip(range(1, 5), reversed(skips)):
            up = self._convt(h, p[f"up{i}/up/w"], p[f"up{i}/up/b"])
            dy, dx = skip.shape[2] - up.shape[2], skip.shape[3] - up.shape[3]
            up = F.pad(up, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
            skip = self._gate(up, skip, p, f"up{i}/att", state, train)
            h = self._rrcnn(torch.cat([skip, up], 1), p, f"up{i}/conv", state, train)
        return self._conv(h, p["outc/w"], 0) + p["outc/b"].view(1, -1, 1, 1)


def train_steps(config: dict, weights: dict, bn_state: dict, batches, *, lr: float,
                quant: Quant | None = None, half_batch: bool = False) -> dict:
    """``reference.train_steps`` on this ``Model``: the recipe's first
    ``len(batches)`` steps from ``weights`` (BCE + Dice, ``clip_grad_norm_``
    at 1.0, ``torch.optim.RMSprop``), each step's loss, each leaf's first
    gradient as RMSprop takes it and each leaf's change after the last step
    as norms by path, its square average then on the host (``sq1``), and
    the running statistics after the first step (``bn1``) and after the
    last (``bn_state``) by path.
    ``half_batch`` is the fault that leaves half of each batch out."""
    _check(config)
    model = Model(config, quant)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    state = {k: v.detach().clone() for k, v in bn_state.items()}
    opt = torch.optim.RMSprop(list(params.values()), lr=lr, alpha=reference.ALPHA, eps=1e-8,
                              weight_decay=1e-8, momentum=0.999)
    losses, grad, step_s = [], {}, []
    for k, (images, masks) in enumerate(batches):
        t0 = time.perf_counter()
        if half_batch:
            images, masks = images[: len(images) // 2], masks[: len(masks) // 2]
        opt.zero_grad(set_to_none=True)
        loss = reference.criterion(model(params, state, reference.nchw(images), train=True),
                                   masks)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(params.values()), 1.0)
        opt.step()
        losses.append(float(loss.detach()))
        step_s.append(time.perf_counter() - t0)
        if k == 0:
            sq1 = {n: opt.state[p]["square_avg"].to("cpu", copy=True) for n, p in params.items()}
            grad = dict(zip(params, reference.grad_norms(sq1.values())))
            bn1 = {n: v.clone() for n, v in state.items()}
    change = dict(zip(params, reference.norms([p.detach() - weights[n]
                                               for n, p in params.items()])))
    return {"loss": losses, "grad": grad, "change": change, "step_s": step_s, "bn1": bn1,
            "sq1": sq1, "bn_state": state}


def model_convs(config: dict, h: int, w: int) -> list[dict]:
    """Every conv of one image's forward, in ``yardstick.model_convs``'
    form: a recurrent unit's shared 3x3 conv once for each of its t+1
    applications (``<block>.rec1.0`` .. ``.rec1.<t>``), so that a count of
    weights would be t+1 times short; the first conv (``inc.proj``, on the
    image) needs no dx."""
    _check(config)
    t = config["recur_t"]
    px = [a * b for a, b in yardstick.level_sizes(h, w)]
    lv = yardstick.level_sizes(h, w)
    enc, dec = _plan(config)
    convs = []

    def rrcnn(name, cin, cout, level, dx):
        convs.append(dict(name=f"{name}.proj", k=1, cin=cin, cout=cout, px_in=px[level],
                          px_out=px[level], dx=dx))
        for unit in ("rec1", "rec2"):
            for i in range(t + 1):
                convs.append(dict(name=f"{name}.{unit}.{i}", k=3, cin=cout, cout=cout,
                                  px_in=px[level], px_out=px[level], dx=True))

    for i, (cin, cout) in enumerate(enc):
        rrcnn("inc" if i == 0 else f"down{i}", cin, cout, i, i > 0)
    for i, (skip, cin, g_ch) in enumerate(dec, start=1):
        lvl = 4 - i  # the skip's level
        up_px = 4 * lv[lvl + 1][0] * lv[lvl + 1][1]
        convs.append(dict(name=f"up{i}.up", k=1, taps=4, cin=cin, cout=g_ch,
                          px_in=px[lvl + 1], px_out=up_px, dx=True, transpose=True))
        f_int = max(1, skip // 2)
        convs += [dict(name=f"up{i}.att.wg", k=1, cin=g_ch, cout=f_int, px_in=px[lvl],
                       px_out=px[lvl], dx=True),
                  dict(name=f"up{i}.att.wx", k=1, cin=skip, cout=f_int, px_in=px[lvl],
                       px_out=px[lvl], dx=True),
                  dict(name=f"up{i}.att.psi", k=1, cin=f_int, cout=1, px_in=px[lvl],
                       px_out=px[lvl], dx=True)]
        rrcnn(f"up{i}.conv", skip + g_ch, skip, lvl, True)
    convs.append(dict(name="outc", k=1, cin=config["base_channels"],
                      cout=config["n_classes"], px_in=px[0], px_out=px[0], dx=True))
    return convs


def forward_flops(config: dict, h: int, w: int) -> float:
    """Model FLOPs of one image's forward."""
    return sum(yardstick._fwd(cv) for cv in model_convs(config, h, w))


def train_flops(config: dict, h: int, w: int) -> float:
    """Model FLOPs of one image's train step: forward, dw, and dx of every
    conv but the first, each recurrent application counted; no
    recomputation (``yardstick.train_flops``' conventions)."""
    return sum(yardstick._fwd(cv) * (3 if cv["dx"] else 2) for cv in model_convs(config, h, w))


def conv_bound_s(config: dict, h: int, w: int, dtype: str, *, train: bool) -> float:
    """Σ over one image's convs (forward; with ``train`` also dw and dx) of
    the least time each could take on the card (``yardstick.conv_bound_s``'
    conventions: each input byte read once, each output byte written once)."""
    e = yardstick.ELEMENT_BYTES[dtype]
    total = 0.0
    for cv in model_convs(config, h, w):
        f, b = yardstick._fwd(cv), yardstick._bytes(cv, e)
        for p in ("fwd", "dw", "dx") if train else ("fwd",):
            if p == "dx" and not cv["dx"]:
                continue
            total += yardstick.bound_s(f, b[p], dtype)
    return total
