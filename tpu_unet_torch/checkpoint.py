"""Checkpoints in the JAX package's ``.npz`` format (``tpu_unet/checkpoint.py``),
read and written with numpy alone.

A file holds one array per parameter or BN statistic under its keypath
(``params/inc/conv1/w``, ``state/inc/bn1/mean``, ...), optionally the
optimizer state under ``opt/`` with the keypaths JAX gives its NamedTuple
fields (``opt/square_avg/inc/conv1/w``, ``opt/step``), plus a ``__meta__``
JSON entry with ``mask_values``, ``extra`` (``extra["config"]`` is the
model's ``UNetConfig``) and ``has_opt_state``. A checkpoint written by
either package loads in the other unchanged.

The reference's own format, a torch ``.pth`` state dict with its
``mask_values`` list, is read by ``import_pth`` and written by
``export_pth``; ``average_checkpoints`` averages ``.npz`` files.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from tpu_unet_torch.models.unet import Params, Refused, State, UNetConfig, init_unet, tree_map
from tpu_unet_torch.ops.batchnorm import BNState
from tpu_unet_torch.optim import AdamState, RMSpropState, SGDState

# The port's NamedTuple for each of the JAX package's, by class name.
_NAMED_TUPLES = {cls.__name__: cls for cls in (BNState, RMSpropState, SGDState, AdamState)}


def _flatten(tree, prefix: str, out: dict[str, np.ndarray]) -> None:
    if isinstance(tree, tuple):  # a NamedTuple: its fields name the keys
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else k, out)
    else:
        out[prefix] = tree.detach().cpu().numpy()


def flatten(params: Params, state: State) -> dict[str, np.ndarray]:
    """The checkpoint's keypath -> array map of (params, state)."""
    out: dict[str, np.ndarray] = {}
    _flatten(params, "params", out)
    _flatten(state, "state", out)
    return out


def from_jax_arrays(flat: dict[str, np.ndarray],
                    device: str | torch.device = "cpu") -> tuple[Params, State]:
    """Turn the flattened JAX params and state (``params/...`` and
    ``state/...`` keypaths; anything else is ignored) into the port's nested
    dicts of tensors, with every ``{mean, var}`` state node a ``BNState``."""
    trees: dict[str, dict] = {"params": {}, "state": {}}
    for key, arr in flat.items():
        root, _, path = key.partition("/")
        if root not in trees or not path:
            continue
        node = trees[root]
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(arr)).to(device)

    def to_bn(tree):
        if set(tree) == {"mean", "var"}:
            return BNState(mean=tree["mean"], var=tree["var"])
        return {k: to_bn(v) if isinstance(v, dict) else v for k, v in tree.items()}

    return trees["params"], to_bn(trees["state"])


def tree_from_numpy(tree, device: str | torch.device = "cpu"):
    """Turn a JAX pytree with numpy leaves (params, BN state, gradients, an
    ``RMSpropState``, ...: nested dicts and NamedTuples) into the port's tree:
    dicts stay dicts, each array becomes a tensor on ``device``, and each
    NamedTuple becomes the port's class of the same name."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        name = type(tree).__name__
        if name not in _NAMED_TUPLES:
            raise TypeError(f"tree_from_numpy: no port counterpart for {name}")
        return _NAMED_TUPLES[name](*(tree_from_numpy(v, device) for v in tree))
    return torch.from_numpy(np.array(tree)).to(device)


def save_checkpoint(path: str | Path, params: Params, state: State, mask_values=None,
                    extra: dict | None = None, opt_state=None) -> None:
    """Write params + BN state (+ ``mask_values`` palette, + ``extra``, +
    the optimizer state for a full resume)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = flatten(params, state)
    if opt_state is not None:
        _flatten(opt_state, "opt", arrays)
    meta = {"mask_values": mask_values, "extra": extra or {},
            "has_opt_state": opt_state is not None}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    # An explicit file object: np.savez appends '.npz' to suffix-less paths.
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def read_checkpoint_meta(path: str | Path) -> tuple[list | None, dict]:
    """(mask_values, extra) without loading the arrays."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tolist()).decode("utf-8"))
    return meta.get("mask_values"), meta.get("extra", {})


def _restore(z, key: str, like, device, path):
    """The tree of ``like``'s structure read from the file's ``key/...``
    entries, each leaf in its ``like`` leaf's dtype and shape."""
    if isinstance(like, dict):
        return {k: _restore(z, f"{key}/{k}", v, device, path) for k, v in like.items()}
    if isinstance(like, tuple):
        return type(like)(*(_restore(z, f"{key}/{f}", v, device, path)
                            for f, v in zip(like._fields, like)))
    if key not in z.files:
        raise KeyError(f"checkpoint {path} has no entry {key!r}")
    arr = z[key]
    if arr.shape != tuple(like.shape):
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(like.shape)}")
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=like.dtype)


def _layout_hint(key: str) -> str:
    """Why a recurrent unit's BN entry may be missing: the file holds the
    other ``recur_bn`` layout (the JAX package's wording)."""
    if "/rec" in key and "/bn0/" in key:
        return (" — a per-step recurrent-BN template cannot load a shared-layout "
                "checkpoint (written pre-r5 or with recur_bn='shared'); rebuild with "
                "UNetConfig(recur_bn='shared')")
    if "/rec" in key and "/bn/" in key:
        return (" — a shared recurrent-BN template cannot load a per-step checkpoint; "
                "rebuild with the default UNetConfig(recur_bn='per_step')")
    return ""


def load_checkpoint(path: str | Path, config: UNetConfig | None = None,
                    device: str | torch.device = "cpu", opt_like=None
                    ) -> tuple[Params, State, list | None, dict]:
    """Read (params, state, mask_values, extra). With ``config``, every key
    the model needs must be present with its shape, or this raises. With
    ``opt_like`` (an optimizer state of the run's structure) and optimizer
    state in the file, ``extra["opt_state"]`` is that state, restored."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tolist()).decode("utf-8"))
        flat = {k: z[k] for k in z.files if k.startswith(("params/", "state/"))}
        opt_state = None
        if opt_like is not None and meta.get("has_opt_state"):
            opt_state = _restore(z, "opt", opt_like, device, path)
    if config is not None:
        # The template of any family (init_unet dispatches on config.arch);
        # its values are never used.
        template = flatten(*init_unet(config, np.random.default_rng(0)))
        for key, like in template.items():
            if key not in flat:
                raise KeyError(f"checkpoint {path} has no entry {key!r}{_layout_hint(key)}")
            if flat[key].shape != like.shape:
                raise ValueError(f"shape mismatch for {key}: {flat[key].shape} vs {like.shape}")
    params, state = from_jax_arrays(flat, device)
    extra = dict(meta.get("extra", {}))
    if opt_state is not None:
        extra["opt_state"] = opt_state
    return params, state, meta.get("mask_values"), extra


def _to_host(tree):
    return None if tree is None else tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


class AsyncCheckpointer:
    """Checkpoint writes that overlap training: ``save`` copies the trees to
    host memory at once, then serializes and writes the file on a thread.
    ``wait()`` joins the write in flight; ``save`` calls it before starting
    the next one, and the trainer at exit."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, path, params, state, mask_values=None, extra=None, opt_state=None) -> None:
        host = (_to_host(params), _to_host(state), mask_values, extra, _to_host(opt_state))
        self.wait()
        self._thread = threading.Thread(target=save_checkpoint, args=(path, *host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def average_checkpoints(paths, out_path: str | Path) -> None:
    """Uniform weight average of ``.npz`` checkpoints (SWA-style), written as
    a standard checkpoint: every ``params/*`` and ``state/*`` array is
    averaged in float64 and cast back to its dtype. BN running statistics
    are averaged too (an approximation: SWA proper re-estimates them); the
    optimizer state is dropped; ``mask_values`` and ``extra`` come from the
    LAST input, with ``extra["averaged_from"]`` the inputs' file names."""
    paths = [Path(p) for p in paths]
    if not paths:
        raise ValueError("average_checkpoints needs at least one input")
    sums: dict[str, np.ndarray] = {}
    dtypes: dict[str, np.dtype] = {}
    meta: dict = {}
    for p in paths:
        with np.load(p, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"].tolist()).decode("utf-8"))
            keys = [k for k in z.files if k.startswith(("params/", "state/"))]
            if sums and set(keys) != set(sums):
                raise ValueError(f"{p} has a different parameter tree than {paths[0]} "
                                 "— cannot average")
            for k in keys:
                arr = z[k].astype(np.float64)
                if k not in sums:
                    sums[k], dtypes[k] = arr.copy(), z[k].dtype
                elif arr.shape != sums[k].shape:
                    raise ValueError(f"shape mismatch for {k} in {p}: "
                                     f"{arr.shape} vs {sums[k].shape}")
                else:
                    sums[k] += arr
    inv = 1.0 / len(paths)
    arrays = {k: (v * inv).astype(dtypes[k]) for k, v in sums.items()}
    extra = dict(meta.get("extra", {}))
    extra["averaged_from"] = [p.name for p in paths]
    out_meta = {"mask_values": meta.get("mask_values"), "extra": extra, "has_opt_state": False}
    arrays["__meta__"] = np.frombuffer(json.dumps(out_meta).encode("utf-8"), dtype=np.uint8)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "wb") as f:
        np.savez(f, **arrays)


def _check_pth(config: UNetConfig, direction: str) -> None:
    """``.pth`` is the reference U-Net's layout; the other families'
    checkpoints are .npz (the JAX package's wording, tpu_unet/hub.py)."""
    if config.arch != "unet":
        raise Refused(f".pth {direction} is reference-layout (flagship) only; "
                      f"arch={config.arch!r} checkpoints are .npz")


def export_pth(path: str | Path, params: Params, state: State, config: UNetConfig, *,
               mask_values: list | None = None) -> None:
    """Write a torch ``.pth`` state dict that the reference's U-Net loads with
    ``load_state_dict`` (``torch.save(state_dict ∪ {"mask_values"})``).

    Keys are the upstream module names (``inc.double_conv.0.weight``,
    ``downN.maxpool_conv.1.double_conv...``, ``upN.up``,
    ``upN.conv.double_conv...``, ``outc.conv``); HWIO conv weights become
    OIHW, ConvTranspose weights (kH,kW,I,O) become (I,O,kH,kW), and each BN's
    ``num_batches_tracked`` is written as 0. ``config`` gives the decoder
    (``bilinear`` writes no ConvTranspose); ``arch`` other than ``unet``
    raises."""
    _check_pth(config, "export")

    def t(x: torch.Tensor, *perm: int) -> torch.Tensor:
        x = x.detach().to("cpu")
        return (x.permute(*perm) if perm else x).contiguous().clone()

    sd: dict = {}

    def double_conv(prefix: str, p: dict, s: dict) -> None:
        # Sequential indices: 0 conv, 1 bn, 2 relu, 3 conv, 4 bn, 5 relu.
        for idx, conv, bn in ((0, "conv1", "bn1"), (3, "conv2", "bn2")):
            sd[f"{prefix}.{idx}.weight"] = t(p[conv]["w"], 3, 2, 0, 1)
            sd[f"{prefix}.{idx + 1}.weight"] = t(p[bn]["scale"])
            sd[f"{prefix}.{idx + 1}.bias"] = t(p[bn]["bias"])
            sd[f"{prefix}.{idx + 1}.running_mean"] = t(s[bn].mean)
            sd[f"{prefix}.{idx + 1}.running_var"] = t(s[bn].var)
            sd[f"{prefix}.{idx + 1}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    double_conv("inc.double_conv", params["inc"], state["inc"])
    for b in ("down1", "down2", "down3", "down4"):
        double_conv(f"{b}.maxpool_conv.1.double_conv", params[b], state[b])
    for b in ("up1", "up2", "up3", "up4"):
        if not config.bilinear:
            sd[f"{b}.up.weight"] = t(params[b]["up"]["w"], 2, 3, 0, 1)
            sd[f"{b}.up.bias"] = t(params[b]["up"]["b"])
        double_conv(f"{b}.conv.double_conv", params[b]["conv"], state[b]["conv"])
    sd["outc.conv.weight"] = t(params["outc"]["w"], 3, 2, 0, 1)
    sd["outc.conv.bias"] = t(params["outc"]["b"])
    if mask_values is not None:
        sd["mask_values"] = list(mask_values)  # every reference loader pops it first
    torch.save(sd, str(path))


def import_pth(path: str | Path, config: UNetConfig, device: str | torch.device = "cpu"
               ) -> tuple[Params, State, list | None]:
    """(params, state, mask_values) from a torch U-Net ``.pth`` state dict.

    The reference's layout, by tensor ORDER within each top-level block
    (inc, down1..4, up1..4, outc): a DoubleConv is conv w, bn weight, bias,
    running mean, running var (``num_batches_tracked`` skipped), twice; an
    up block starts with the ConvTranspose weight and bias unless
    ``config.bilinear``; outc is a 1x1 conv w and b. ``mask_values`` (a list
    of ints or of lists) is popped first, as every reference loader does.
    Loaded with ``weights_only=True``: tensors and plain lists only. The
    other families have no ``.pth`` layout (their checkpoints are ``.npz``,
    as in the JAX package): ``config.arch`` other than ``unet`` raises."""
    _check_pth(config, "import")
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    mask_values = sd.pop("mask_values", None)
    if hasattr(mask_values, "tolist"):
        mask_values = mask_values.tolist()
    groups: dict[str, list[torch.Tensor]] = {}
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            groups.setdefault(k.split(".")[0], []).append(v.detach())

    def hwio(w: torch.Tensor, *perm: int) -> torch.Tensor:
        return w.permute(*perm).contiguous().to(device)

    def double_conv(ts: list[torch.Tensor]):
        if len(ts) != 10:
            raise ValueError(f"{path}: a DoubleConv has 10 tensors, got {len(ts)}")
        c1, g1, b1, m1, v1, c2, g2, b2, m2, v2 = ts
        p = {"conv1": {"w": hwio(c1, 2, 3, 1, 0)},
             "bn1": {"scale": g1.to(device), "bias": b1.to(device)},
             "conv2": {"w": hwio(c2, 2, 3, 1, 0)},
             "bn2": {"scale": g2.to(device), "bias": b2.to(device)}}
        s = {"bn1": BNState(m1.to(device), v1.to(device)),
             "bn2": BNState(m2.to(device), v2.to(device))}
        return p, s

    params: Params = {}
    state: State = {}
    for block in ("inc", "down1", "down2", "down3", "down4"):
        params[block], state[block] = double_conv(groups[block])
    for block in ("up1", "up2", "up3", "up4"):
        ts = groups[block]
        if config.bilinear:
            conv_p, conv_s = double_conv(ts)
            params[block] = {"conv": conv_p}
        else:
            conv_p, conv_s = double_conv(ts[2:])
            # torch ConvTranspose2d weight (I, O, kH, kW) -> (kH, kW, I, O)
            params[block] = {"up": {"w": hwio(ts[0], 2, 3, 0, 1), "b": ts[1].to(device)},
                             "conv": conv_p}
        state[block] = {"conv": conv_s}
    out_w, out_b = groups["outc"]
    params["outc"] = {"w": hwio(out_w, 2, 3, 1, 0), "b": out_b.to(device)}
    return params, state, mask_values
