"""NaN checking for every op, the counterpart of JAX's ``jax_debug_nans``
(``train_cli --debug-nans``).

``DebugNans`` is a ``TorchDispatchMode``: inside it every aten op, those of
the autograd backward included, has its floating-point tensors checked for
NaN, and the first op that meets one raises ``FloatingPointError`` naming
it, as JAX raises at the first jitted computation that makes one. The
mode is thread-local: ops on other threads (the loader's decode threads,
the checkpoint writer) are not checked. Outside it nothing is checked and
nothing costs.

Two rules keep it free of false alarms and complete:

- The hand-written kernels (``tpu_unet_torch/kernels``) write through
  ctypes into buffers made by ``torch.empty*``, which the mode cannot see.
  Those factory ops' outputs hold garbage until the kernel writes them, so
  they are not checked, and neither are views, which compute nothing.
- Each op's inputs are checked as well as its outputs, so a NaN that a
  kernel wrote is caught at its first aten consumer. An argument that the
  op writes (``out=``, the ``self`` of an in-place op) is checked as an
  output, never as an input: it may be a fresh buffer.
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
# Ops whose floating outputs are uninitialised memory by design.
_UNINITIALISED = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.empty_permuted,
    _aten.new_empty, _aten.new_empty_strided, _aten.resize_, _aten.resize_as_, _aten.set_,
})


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def _has_nan(t: torch.Tensor) -> bool:
    return (t.is_floating_point() and t.numel() > 0 and t.device.type != "meta"
            and bool(torch.isnan(t).any()))


class DebugNans(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first aten op with a NaN in a
    floating input or output. ``checked`` counts the ops checked, by name."""

    def __init__(self):
        super().__init__()
        self.checked: collections.Counter[str] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if (func.overloadpacket in _UNINITIALISED
                or any(r.alias_info is not None and not r.alias_info.is_write
                       for r in schema.returns)):
            return func(*args, **kwargs)
        self.checked[str(func)] += 1
        written = {a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write}
        named = [*zip((a.name for a in schema.arguments), args), *kwargs.items()]
        for name, value in named:
            if name not in written and any(_has_nan(t) for t in _tensors(value)):
                raise FloatingPointError(f"invalid value (nan) in input {name!r} of {func}")
        out = func(*args, **kwargs)
        if any(_has_nan(t) for t in _tensors(out)):
            raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out
