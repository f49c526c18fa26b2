"""What the benchmark makes from ``--seed`` and hands to both the program and
the reference: the weights, the BN statistics, and synthetic Carvana
images with their masks. Everything is drawn on the device with one
``torch.Generator``, in a few large calls.

Weights follow torch's default init bounds, U(-1/sqrt(fan_in),
1/sqrt(fan_in)) (a ConvTranspose's fan_in is Cout·k·k), with BN at scale 1,
bias 0 and running statistics (0, 1): a model at the start of training.
Leaves are keyed by path (``inc/conv1/w``) in the program's layouts: HWIO
conv weights, channels-last images.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & SEED_MASK)
    return g


def _double_conv(prefix: str, cin: int, cout: int) -> list:
    return [(f"{prefix}/conv1/w", (3, 3, cin, cout), cin * 9),
            (f"{prefix}/bn1/scale", (cout,), "one"), (f"{prefix}/bn1/bias", (cout,), "zero"),
            (f"{prefix}/conv2/w", (3, 3, cout, cout), cout * 9),
            (f"{prefix}/bn2/scale", (cout,), "one"), (f"{prefix}/bn2/bias", (cout,), "zero")]


def layout(config: dict) -> list[tuple[str, tuple, object]]:
    """(path, shape, init) of every parameter, init a fan-in (uniform
    draw) or "one" / "zero", in the order of the program's trees."""
    if config["arch"] not in ("unet", "attention") or config.get("bilinear"):
        raise ValueError(f"no layout for arch {config['arch']!r} (ConvTranspose decoder only)")
    c = config["base_channels"]
    enc = [(config["n_channels"], c), (c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c),
           (8 * c, 16 * c)]
    out = []
    for i, (cin, cout) in enumerate(enc):
        out += _double_conv("inc" if i == 0 else f"down{i}", cin, cout)
    for i in range(1, 5):
        cin, skip = 16 * c // 2 ** (i - 1), 8 * c // 2 ** (i - 1)
        g_ch = cin // 2
        p = f"up{i}"
        out += [(f"{p}/up/w", (2, 2, cin, g_ch), g_ch * 4), (f"{p}/up/b", (g_ch,), g_ch * 4)]
        out += _double_conv(f"{p}/conv", skip + g_ch, skip)
        if config["arch"] == "attention":
            f = max(1, skip // 2)
            out += [(f"{p}/att/wg/w", (1, 1, g_ch, f), g_ch), (f"{p}/att/bn_g/scale", (f,), "one"),
                    (f"{p}/att/bn_g/bias", (f,), "zero"),
                    (f"{p}/att/wx/w", (1, 1, skip, f), skip), (f"{p}/att/bn_x/scale", (f,), "one"),
                    (f"{p}/att/bn_x/bias", (f,), "zero"),
                    (f"{p}/att/psi/w", (1, 1, f, 1), f), (f"{p}/att/bn_psi/scale", (1,), "one"),
                    (f"{p}/att/bn_psi/bias", (1,), "zero")]
    n = config["n_classes"]
    out += [("outc/w", (1, 1, c, n), c), ("outc/b", (n,), c)]
    return out


def bn_layers(config: dict) -> list[tuple[str, int]]:
    """(path, channels) of every BN layer: the ``.../bnX/scale`` leaves."""
    return [(p[: -len("/scale")], shape[0]) for p, shape, _ in layout(config)
            if p.endswith("/scale")]


def make_weights(config: dict, g: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Every parameter as fp32 on ``device``: one uniform draw for all the
    drawn leaves, split and scaled by each leaf's bound."""
    leaves = layout(config)
    drawn = [(p, s, fan) for p, s, fan in leaves if not isinstance(fan, str)]
    total = sum(math.prod(s) for _, s, _ in drawn)
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


def carvana_images(g: torch.Generator, n: int, h: int, w: int, device) -> tuple:
    """``n`` synthetic Carvana studio shots, uint8 [n,h,w,3], and their car
    masks, bool [n,h,w]: a light backdrop with a vertical gradient and noise
    of low frequency, a floor shadow, and a car of any hue as an ellipse
    with a highlight band. Every image differs."""
    yy = torch.linspace(0, 1, h, device=device).view(1, 1, h, 1)
    xx = torch.linspace(0, 1, w, device=device).view(1, 1, 1, w)
    r = torch.rand(n, 12, generator=g, device=device).view(n, 12, 1, 1)
    cy, cx = 0.40 + 0.2 * r[:, 0:1], 0.35 + 0.3 * r[:, 1:2]  # [n,1,1,1]
    ry, rx = 0.16 + 0.1 * r[:, 2:3], 0.25 + 0.12 * r[:, 3:4]
    car = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1  # [n,1,h,w]
    shadow = ((yy - cy - 0.85 * ry) / (0.35 * ry)) ** 2 + ((xx - cx) / (1.1 * rx)) ** 2 < 1
    low = torch.rand(n, 3, 9, 13, generator=g, device=device)
    low = F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    back = 0.72 + 0.1 * r[:, 4:5] + 0.08 * (yy - 0.5) + 0.06 * (low - 0.5)  # [n,3,h,w]
    back = back * torch.where(shadow & ~car, 0.55 + 0.2 * r[:, 5:6], 1.0)
    hue = r[:, 6:9] * (0.05 + 0.5 * r[:, 9:10])  # capped luminance, any hue
    band = torch.exp(-(((yy - cy + 0.3 * ry) / (0.08 * ry)) ** 2)) * 0.25 * r[:, 10:11]
    img = torch.where(car, hue + band + 0.04 * (low - 0.5), back)
    img = img + 0.01 * (torch.rand(n, 3, h, w, generator=g, device=device) - 0.5)
    u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    return u8, car[:, 0]


def train_pool(g: torch.Generator, batches: int, batch: int, h: int, w: int, device):
    """``batches`` train batches: fp32 images k/255 [batch,h,w,3] and int64
    masks [batch,h,w], as the program's loader gives them."""
    u8, car = carvana_images(g, batches * batch, h, w, device)
    imgs = (u8.float() / 255.0).split(batch)
    masks = car.long().split(batch)
    return [t.contiguous() for t in imgs], [t.contiguous() for t in masks]
