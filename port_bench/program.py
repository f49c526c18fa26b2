"""Where the benchmark meets the program: its config type and its trees.

The benchmark makes the weights and BN statistics itself (``inputs.py``),
keyed by path; these functions put them into the program's trees, checking
that the program's parameters are the benchmark's one to one, paths and
shapes.
"""

from __future__ import annotations


def program_trees(meta, values: dict, prefix: str = ""):
    """The program's tree ``meta`` (dicts and NamedTuples, on the meta
    device) with each leaf taken from ``values`` by path; raises unless
    paths and shapes match one to one."""
    if isinstance(meta, dict):
        return {k: program_trees(v, values, f"{prefix}{k}/") for k, v in meta.items()}
    if isinstance(meta, tuple):
        return type(meta)(*(program_trees(v, values, f"{prefix}{f}/")
                            for f, v in zip(meta._fields, meta)))
    path = prefix[:-1]
    t = values[path]
    if tuple(t.shape) != tuple(meta.shape):
        raise ValueError(f"{path}: the benchmark's shape {tuple(t.shape)} is not the "
                         f"program's {tuple(meta.shape)}")
    return t


def leaves_by_path(tree, prefix: str = "") -> dict:
    """{path: leaf} of a tree of dicts."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(leaves_by_path(v, f"{prefix}{k}/"))
    return out


def model_config(cfg: dict):
    """The program's ``UNetConfig`` of a configuration file."""
    from tpu_unet_torch.models.unet import UNetConfig

    m = cfg["model"]
    return UNetConfig(n_channels=m["n_channels"], n_classes=m["n_classes"],
                      bilinear=m["bilinear"], base_channels=m["base_channels"], arch=m["arch"])


def trees_for(mcfg, weights: dict, bn_state: dict):
    """The program's (params, BN state) trees holding the benchmark's
    tensors."""
    from tpu_unet_torch.models.unet import init_unet

    meta_p, meta_s = init_unet(mcfg, None, device="meta")
    n_meta = len(leaves_by_path(meta_p))
    if n_meta != len(weights):
        raise ValueError(f"the program has {n_meta} parameters, the benchmark {len(weights)}")
    return program_trees(meta_p, weights), program_trees(meta_s, bn_state)


def train_size(cfg: dict) -> tuple[int, int]:
    """(H, W) of the images the model sees: the configuration's image
    scaled as the program's preprocess scales it."""
    s = cfg["image"]["scale"]
    return int(s * cfg["image"]["height"]), int(s * cfg["image"]["width"])
