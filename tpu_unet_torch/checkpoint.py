"""Checkpoints in the JAX package's ``.npz`` format (``tpu_unet/checkpoint.py``),
read and written with numpy alone.

A file holds one array per parameter or BN statistic under its keypath
(``params/inc/conv1/w``, ``state/inc/bn1/mean``, ...), optionally the
optimizer state under ``opt/`` with the keypaths JAX gives its NamedTuple
fields (``opt/square_avg/inc/conv1/w``, ``opt/step``), plus a ``__meta__``
JSON entry with ``mask_values``, ``extra`` (``extra["config"]`` is the
model's ``UNetConfig``) and ``has_opt_state``. A checkpoint written by
either package loads in the other unchanged.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import torch

from tpu_unet_torch.models.unet import Params, State, UNetConfig, init_unet, tree_map
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
        template = flatten(*init_unet(config, np.random.default_rng(0)))
        for key, like in template.items():
            if key not in flat:
                raise KeyError(f"checkpoint {path} has no entry {key!r}")
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
