"""The benchmark's own arithmetic: the H100's peaks, the model FLOPs and
bytes of every conv from a configuration's shapes, the kernel-name patterns
that split device time into conv and glue, and the rate and percentile
rules. Nothing here imports the program, so a change to the program cannot
move the yardstick.

Origins (copied, then changed where said):
- ``bound`` and ``conv_flops``: ``chip_smoke.py``. The fp32 peak is changed
  from 494.7 / 3 TFLOP/s (the rate of one implementation, 3xTF32) to the
  chip's 494.7 TFLOP/s of dense TF32: the highest rate at which the card
  does any multiply-add of fp32 inputs, so no implementation, library or
  hand-written, can read over 100% against it. 3xTF32's own ceiling is a
  third of it.
- ``CONV_PATTERNS`` / ``GLUE_PATTERNS``: ``tpu_unet_torch/tools/profile_step.py``
  (``PROFILE_GROUPS``), regrouped into two classes.
- ``percentile``: the nearest-rank rule of ``tpu_unet_torch/serve.py``
  (``ServeMetrics.snapshot``), over every sample rather than a sliding
  window.
"""

from __future__ import annotations

import math

# Published NVIDIA H100 SXM figures, dense, at the 700 W limit.
PEAK_FLOP_S = {"bf16": 989e12, "fp32": 494.7e12}
HBM_BYTES_S = 3.35e12
ELEMENT_BYTES = {"bf16": 2, "fp32": 4}

# A kernel is conv work if its lower-cased name holds one of these (checked
# first), glue if it holds one of GLUE_PATTERNS, and conv otherwise: a renamed
# or new kernel then counts as conv, so a conv roofline share can read low
# but never high. reduce_rows is the fixed-order sum of the hand-written
# convs' split-K partials (dw) and BN-statistic partials.
CONV_PATTERNS = (
    "tc_conv", "tc_dw", "tc_double_conv", "split_weights", "split_dx_weights", "reduce_rows",
    "conv", "cudnn", "xmma", "cutlass", "gemm", "sm90_", "sm80_", "nchwtonhwc", "nhwctonchw",
    "winograd", "fft",
)
GLUE_PATTERNS = (
    "elementwise", "vectorized", "reduce", "copy", "fill", "memcpy", "memset", "pool", "index",
    "gather", "scatter", "upsample", "interp", "softmax", "where", "cat",
)


def is_conv_kernel(name: str) -> bool:
    low = name.lower()
    if any(p in low for p in CONV_PATTERNS):
        return True
    return not any(p in low for p in GLUE_PATTERNS)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate of ``dtype`` and the bytes over the HBM rate."""
    return max(flops / PEAK_FLOP_S[dtype], nbytes / HBM_BYTES_S)


def conv_flops(pixels_out: int, k: int, cin: int, cout: int) -> float:
    """2·k·k·Cin·Cout operations per output pixel (a ConvTranspose k2 s2
    reads one tap per output pixel: pass k=1 with its output pixels)."""
    return 2.0 * k * k * cin * cout * pixels_out


def level_sizes(h: int, w: int, depth: int = 5) -> list[tuple[int, int]]:
    """(H, W) of each encoder level: 2x2 max pools with floor."""
    out = [(h, w)]
    for _ in range(depth - 1):
        h, w = h // 2, w // 2
        out.append((h, w))
    return out


def model_convs(config: dict, h: int, w: int) -> list[dict]:
    """Every conv of one image's forward, from the configuration's shapes:
    name, k, cin, cout, input and output pixels, and whether its input
    needs a gradient (the first conv's does not). The U-Net of
    ``config["arch"] == "unet"`` (ConvTranspose decoder) and Attention
    U-Net (``"attention"``: three 1x1 gate convs a decoder level)."""
    if config.get("bilinear"):
        raise ValueError("model_convs counts the ConvTranspose decoder only")
    c = config["base_channels"]
    lv = level_sizes(h, w)
    px = [a * b for a, b in lv]
    enc = [(config["n_channels"], c), (c, 2 * c), (2 * c, 4 * c), (4 * c, 8 * c),
           (8 * c, 16 * c)]
    convs = []
    for i, (cin, cout) in enumerate(enc):
        name = "inc" if i == 0 else f"down{i}"
        convs.append(dict(name=f"{name}.conv1", k=3, cin=cin, cout=cout, px_in=px[i],
                          px_out=px[i], dx=i > 0))
        convs.append(dict(name=f"{name}.conv2", k=3, cin=cout, cout=cout, px_in=px[i],
                          px_out=px[i], dx=True))
    for i in range(1, 5):
        lvl = 4 - i  # the skip's level
        cin, skip = 16 * c // 2 ** (i - 1), 8 * c // 2 ** (i - 1)
        g_ch = cin // 2
        up_h, up_w = 2 * lv[lvl + 1][0], 2 * lv[lvl + 1][1]
        convs.append(dict(name=f"up{i}.up", k=1, taps=4, cin=cin, cout=g_ch,
                          px_in=px[lvl + 1], px_out=up_h * up_w, dx=True, transpose=True))
        if config["arch"] == "attention":
            f_int = max(1, skip // 2)
            convs += [dict(name=f"up{i}.att.wg", k=1, cin=g_ch, cout=f_int, px_in=px[lvl],
                           px_out=px[lvl], dx=True),
                      dict(name=f"up{i}.att.wx", k=1, cin=skip, cout=f_int, px_in=px[lvl],
                           px_out=px[lvl], dx=True),
                      dict(name=f"up{i}.att.psi", k=1, cin=f_int, cout=1, px_in=px[lvl],
                           px_out=px[lvl], dx=True)]
        elif config["arch"] != "unet":
            raise ValueError(f"model_convs: no count for arch {config['arch']!r}")
        out = skip  # the decoder block's output channels: 512, 256, 128, 64 at base 64
        convs.append(dict(name=f"up{i}.conv1", k=3, cin=skip + g_ch, cout=out, px_in=px[lvl],
                          px_out=px[lvl], dx=True))
        convs.append(dict(name=f"up{i}.conv2", k=3, cin=out, cout=out, px_in=px[lvl],
                          px_out=px[lvl], dx=True))
    convs.append(dict(name="outc", k=1, cin=c, cout=config["n_classes"], px_in=px[0],
                      px_out=px[0], dx=True))
    return convs


def param_count(config: dict) -> int:
    """Parameters of the configuration: conv weights, the ConvTransposes'
    and the head's biases, and two BN parameters a BN channel."""
    n = 0
    for cv in model_convs(config, 64, 64):
        n += _taps(cv) * cv["cin"] * cv["cout"]
        if cv.get("transpose") or cv["name"] == "outc":
            n += cv["cout"]  # bias
        else:
            n += 2 * cv["cout"]  # the BN after it: scale and bias
    return n


def _taps(cv: dict) -> int:
    """Weights a (Cin, Cout) pair: k·k, or 4 for the ConvTranspose k2 s2."""
    return cv.get("taps", cv["k"] ** 2)


def _fwd(cv: dict) -> float:
    return conv_flops(cv["px_out"], cv["k"], cv["cin"], cv["cout"])


def forward_flops(config: dict, h: int, w: int) -> float:
    """Model FLOPs of one image's forward."""
    return sum(_fwd(cv) for cv in model_convs(config, h, w))


def train_flops(config: dict, h: int, w: int) -> float:
    """Model FLOPs of one image's train step: forward, dw, and dx of every
    conv but the first; no recomputation."""
    return sum(_fwd(cv) * (3 if cv["dx"] else 2) for cv in model_convs(config, h, w))


def _bytes(cv: dict, e: int) -> dict[str, float]:
    x = cv["px_in"] * cv["cin"] * e
    y = cv["px_out"] * cv["cout"] * e
    wt = _taps(cv) * cv["cin"] * cv["cout"] * e
    # Each input byte read once, each output byte written once.
    return {"fwd": x + wt + y, "dw": x + y + wt, "dx": y + wt + x}


def conv_bound_s(config: dict, h: int, w: int, dtype: str, *, train: bool) -> float:
    """Σ over one image's convs (forward; with ``train`` also dw and dx) of
    the least time each could take on the card."""
    e = ELEMENT_BYTES[dtype]
    total = 0.0
    for cv in model_convs(config, h, w):
        f, b = _fwd(cv), _bytes(cv, e)
        passes = ("fwd", "dw", "dx") if train else ("fwd",)
        for p in passes:
            if p == "dx" and not cv["dx"]:
                continue
            total += bound_s(f, b[p], dtype)
    return total


def percentile(values, p: float) -> float:
    """Nearest-rank percentile (``ceil(p·n) - 1``) of every value; math.inf
    stands for a failed request."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no samples")
    return vals[max(0, math.ceil(p * len(vals)) - 1)]


def rate(count: int, seconds: float) -> float:
    """Work completed over the whole window."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return count / seconds


def split_device_time(ops) -> tuple[float, float]:
    """(conv seconds, glue seconds) of a trace's [(name, seconds)]."""
    conv = glue = 0.0
    for name, s in ops:
        if is_conv_kernel(name):
            conv += s
        else:
            glue += s
    return conv, glue


def idle_pct(busy_s: float, window_s: float) -> float:
    """Share of the window with no device operation running."""
    return 100.0 * (1.0 - busy_s / window_s)


def request_stats(records, t_end: float, seconds: float, failed_ms: float) -> dict:
    """A closed loop's window from every request issued in it, [(start s,
    end s, ok)]: the masks returned by ``t_end`` over the window's seconds,
    the 95th percentile of every request's latency (a failed one waited
    ``failed_ms``), the attempted and failed counts."""
    lat = [(t1 - t0) * 1e3 if ok else failed_ms for t0, t1, ok in records]
    done = sum(1 for _, t1, ok in records if ok and t1 <= t_end)
    return {"rate": rate(done, seconds), "p95_ms": percentile(lat, 0.95),
            "p50_ms": percentile(lat, 0.50), "done": done, "attempted": len(records),
            "failed": sum(1 for *_, ok in records if not ok)}
