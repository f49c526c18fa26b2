"""Checkpoints in the JAX package's ``.npz`` format (``tpu_unet/checkpoint.py``),
read and written with numpy alone.

A file holds one array per parameter or BN statistic under its keypath
(``params/inc/conv1/w``, ``state/inc/bn1/mean``, ...) plus a ``__meta__``
JSON entry with ``mask_values`` and ``extra`` (``extra["config"]`` is the
model's ``UNetConfig``). A checkpoint written by either package loads in the
other unchanged.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tpu_unet_torch.models.unet import Params, State, UNetConfig, init_unet
from tpu_unet_torch.ops.batchnorm import BNState
from tpu_unet_torch.optim import RMSpropState

# The port's NamedTuple for each of the JAX package's, by class name.
_NAMED_TUPLES = {"BNState": BNState, "RMSpropState": RMSpropState}


def _flatten(tree, prefix: str, out: dict[str, np.ndarray]) -> None:
    if isinstance(tree, BNState):
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
                    extra: dict | None = None) -> None:
    """Write params + BN state (+ ``mask_values`` palette, + ``extra``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = flatten(params, state)
    meta = {"mask_values": mask_values, "extra": extra or {}, "has_opt_state": False}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    # An explicit file object: np.savez appends '.npz' to suffix-less paths.
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def read_checkpoint_meta(path: str | Path) -> tuple[list | None, dict]:
    """(mask_values, extra) without loading the arrays."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tolist()).decode("utf-8"))
    return meta.get("mask_values"), meta.get("extra", {})


def load_checkpoint(path: str | Path, config: UNetConfig | None = None,
                    device: str | torch.device = "cpu"
                    ) -> tuple[Params, State, list | None, dict]:
    """Read (params, state, mask_values, extra). With ``config``, every key
    the model needs must be present with its shape, or this raises."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tolist()).decode("utf-8"))
        flat = {k: z[k] for k in z.files if k.startswith(("params/", "state/"))}
    if config is not None:
        template = flatten(*init_unet(config, np.random.default_rng(0)))
        for key, like in template.items():
            if key not in flat:
                raise KeyError(f"checkpoint {path} has no entry {key!r}")
            if flat[key].shape != like.shape:
                raise ValueError(f"shape mismatch for {key}: {flat[key].shape} vs {like.shape}")
    params, state = from_jax_arrays(flat, device)
    return params, state, meta.get("mask_values"), dict(meta.get("extra", {}))
