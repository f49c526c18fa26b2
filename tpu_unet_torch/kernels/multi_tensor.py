"""Multi-tensor kernels of the train step's update, over lists of leaves of
any shapes (``tpu_unet_torch/csrc/multi_tensor.cu``; its header says what
bounds them on the H100 and how the design answers):

- ``grad_sumsq(grads)``: each leaf's sum of squares, as an fp32 [L] tensor,
  and the global norm, an fp32 0-d tensor (one launch for the squares of
  every chunk of every leaf, one that adds them in a fixed order; the plain
  version returns the same types);
- ``scale_to_norm(grads, total, max_norm)``: every leaf times
  min(max_norm / (total + 1e-6), 1), the coefficient computed on the device
  from ``total`` there (one launch);
- ``rmsprop_step(params, grads, square_avg, momentum_buf, lr, ...)``: one
  RMSprop step of every leaf (one launch), bitwise the plain version's.

They replace no Pallas kernel: they exist because the plain versions, about
18 PyTorch ops a leaf, cost the host as long to dispatch as a bf16 step's
device work. Each returns new tensors and updates nothing in place.

Each wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version (``*_plain``) for CPU tensors, or on any device inside
``plain_versions()``, which a caller enters to choose them: the float64
reference steps do, whose precision the kernels do not compute. It never
falls back: a failed build or launch raises, and so does a dtype the kernels
do not take (params fp32 or bf16, gradients in the params' dtype, the
RMSprop state fp32). The kernels walk
each tensor as a flat array: leaves that are not contiguous (ZeRO's shards,
autograd's gradients of library convs' weights) are copied contiguous first,
once a step where ``clip_grad_norm`` takes them through
``contiguous_leaves``. A table of up to ``MAX_LEAVES`` leaves goes into one
launch's parameters; a larger list takes one launch a table.
``<wrapper>.launches`` counts the calls that launched; ``scale_to_norm`` and
``rmsprop_step`` also count their leaves under ``optim.fused_leaves`` while a
profiler session is on (``tracing.count``).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from collections.abc import Iterator, Sequence

import numpy as np
import torch

from tpu_unet_torch import tracing
from tpu_unet_torch.kernels import _build

_count_lock = threading.Lock()
_plain_chosen = contextvars.ContextVar("multi_tensor_plain", default=False)

# Mirrors of csrc/multi_tensor.cu (a CPU test checks that they agree): the
# values of one leaf a block owns, and the leaves of one launch's table.
CHUNK = 32768
MAX_LEAVES = 256

# clip_grad_norm's guard against a zero norm (torch's clip_grad_norm_).
CLIP_EPS = 1e-6

_PARAM = (torch.float32, torch.bfloat16)
_STATE = (torch.float32,)
_CODES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def grad_sumsq_plain(grads: Sequence[torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor]:
    """(each leaf's sum of squares in fp32, as an [L] tensor, their global
    norm): the squares' sums added in leaf order."""
    sq = [(g.float() * g.float()).sum() for g in grads]
    return torch.stack(sq), torch.sqrt(sum(sq))


def scale_to_norm_plain(grads: Sequence[torch.Tensor], total: torch.Tensor,
                        max_norm: float) -> list[torch.Tensor]:
    """Each leaf times coef = max_norm / (total + 1e-6) where that is below
    1, in fp32, rounded to the leaf's dtype."""
    coef = torch.clamp(max_norm / (total + CLIP_EPS), max=1.0)
    return [(g.float() * coef).to(g.dtype) for g in grads]


def rmsprop_step_plain(params, grads, square_avg, momentum_buf, lr, *, alpha: float = 0.99,
                       eps: float = 1e-8, weight_decay: float = 1e-8, momentum: float = 0.999):
    """(new params, new square averages, new momentum buffers), leaf by leaf
    in torch's update order (``optim/rmsprop.py``)."""

    def leaf(p, g, sq, buf):
        g = g.float()
        pf = p.float()
        if weight_decay != 0:
            g = g + weight_decay * pf
        sq = alpha * sq + (1 - alpha) * (g * g)
        buf = momentum * buf + g / (torch.sqrt(sq) + eps)
        return (pf - lr * buf).to(p.dtype), sq, buf

    new = [leaf(*a) for a in zip(params, grads, square_avg, momentum_buf)]
    return [n[0] for n in new], [n[1] for n in new], [n[2] for n in new]


def chunks(numel: np.ndarray) -> int:
    """Blocks of CHUNK values that leaves of ``numel`` values take; an empty
    leaf takes none."""
    return int(((numel + CHUNK - 1) // CHUNK).sum())


def leaf_table(kernel: str, columns: Sequence[Sequence[torch.Tensor]],
               dtypes: Sequence[tuple[torch.dtype, ...]],
               outputs: Sequence[Sequence[torch.Tensor]] = ()) -> tuple[np.ndarray, np.ndarray,
                                                                         list[int]]:
    """The C interface's table of L leaves. ``columns``: lists of L input
    tensors (e.g. p, g, square_avg, ...), column k in one of ``dtypes[k]``;
    ``outputs``: lists of L tensors the wrapper made like the inputs. Returns
    every leaf's pointers, inputs then outputs, in leaf order (uint64), each
    leaf's values (int64 [L]) and each input column's dtype code. Refuses
    what the kernels do not take: a dtype not listed, a column of mixed
    dtypes, a leaf whose inputs differ in shape, an input on another device
    than the first, or one not contiguous."""
    if len({len(c) for c in (*columns, *outputs)}) != 1:
        raise ValueError(f"{kernel}: the lists of leaves differ in length "
                         f"({[len(c) for c in (*columns, *outputs)]})")
    device, shapes = columns[0][0].device, [t.shape for t in columns[0]]
    codes = []
    for k, col in enumerate(columns):
        dtype = col[0].dtype
        if dtype not in dtypes[k]:
            raise ValueError(f"{kernel}: dtype must be one of {list(dtypes[k])}, got {dtype}")
        for i, (t, shape) in enumerate(zip(col, shapes)):
            if (t.dtype != dtype or t.device != device or t.shape != shape
                    or not t.is_contiguous()):
                raise ValueError(_refusal(kernel, i, t, dtype, device, shape))
        codes.append(_CODES[dtype])
    ptrs = np.array([[t.data_ptr() for t in c] for c in (*columns, *outputs)], np.uint64)
    return ptrs.T.reshape(-1), np.array([t.numel() for t in columns[0]], np.int64), codes


def _refusal(kernel, i, t, dtype, device, shape) -> str:
    if t.dtype != dtype:
        return f"{kernel}: leaf {i} is {t.dtype}, leaf 0 {dtype}: one dtype a list"
    if t.device != device:
        return f"{kernel}: all tensors must be on one device ({t.device} vs {device})"
    if t.shape != shape:
        return f"{kernel}: leaf {i}'s tensors differ in shape ({tuple(t.shape)} vs {tuple(shape)})"
    return f"{kernel}: tensors must be contiguous (leaf {i})"


def contiguous_leaves(leaves: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The leaves as the kernels take them: contiguous copies of those that
    are not; where the plain versions run, as they are."""
    if _plain(leaves):
        return list(leaves)
    return [t if t.is_contiguous() else t.contiguous() for t in leaves]


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Inside, the wrappers run their plain versions whatever the leaves'
    device (in this thread): the float64 reference steps' choice."""
    token = _plain_chosen.set(True)
    try:
        yield
    finally:
        _plain_chosen.reset(token)


def _plain(leaves: Sequence[torch.Tensor]) -> bool:
    """Whether the plain version runs: no leaves, CPU ones, or inside
    ``plain_versions()``."""
    return not leaves or leaves[0].device.type == "cpu" or _plain_chosen.get()


def _launched(fn, leaves: int | None = None) -> None:
    with _count_lock:
        fn.launches += 1
    if leaves is not None:
        tracing.count("optim.fused_leaves", leaves)


def grad_sumsq(grads: Sequence[torch.Tensor]):
    """(each leaf's sum of squares as an [L] tensor, the global norm): fp32,
    on the leaves' device (the kernel's within 1e-6 relative of the plain
    version's)."""
    if _plain(grads):
        return grad_sumsq_plain(grads)
    grads = contiguous_leaves(grads)
    ptrs, numel, codes = leaf_table("grad_sumsq", (grads,), (_PARAM,))
    dev = grads[0].device
    partial = torch.empty(chunks(numel), dtype=torch.float64, device=dev)
    sq = torch.empty(len(grads), dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.library()
    with _build.on_device(grads[0]):
        err = lib.tuk_mt_sumsq(ptrs.ctypes.data, numel.ctypes.data, len(numel), codes[0],
                               partial.data_ptr(), sq.data_ptr(), total.data_ptr(),
                               _build.stream(grads[0]))
    _build.check(err, "grad_sumsq")
    _launched(grad_sumsq)
    return sq, total


def scale_to_norm(grads: Sequence[torch.Tensor], total: torch.Tensor,
                  max_norm: float) -> list[torch.Tensor]:
    """Each leaf times coef = max_norm / (total + 1e-6) where that is below
    1, in the leaf's dtype; ``total`` a one-value tensor (fp32 for the
    kernel, on the leaves' device)."""
    if _plain(grads):
        return scale_to_norm_plain(grads, total, max_norm)
    grads = contiguous_leaves(grads)
    out = [torch.empty_like(g) for g in grads]
    ptrs, numel, codes = leaf_table("scale_to_norm", (grads,), (_PARAM,), (out,))
    if total.numel() != 1 or total.dtype != torch.float32 or total.device != grads[0].device:
        raise ValueError(f"scale_to_norm: total must be one fp32 value on {grads[0].device}, "
                         f"got {total.dtype} {tuple(total.shape)} on {total.device}")
    lib = _build.library()
    with _build.on_device(grads[0]):
        err = lib.tuk_mt_scale(ptrs.ctypes.data, numel.ctypes.data, len(numel), codes[0],
                               total.data_ptr(), max_norm, CLIP_EPS, _build.stream(grads[0]))
    _build.check(err, "scale_to_norm")
    _launched(scale_to_norm, len(grads))
    return out


def rmsprop_step(params, grads, square_avg, momentum_buf, lr, *, alpha: float = 0.99,
                 eps: float = 1e-8, weight_decay: float = 1e-8, momentum: float = 0.999):
    """(new params, new square averages, new momentum buffers), lists in the
    leaves' order: g += wd·p; sq = α·sq + (1−α)·g²; buf = μ·buf + g /
    (sqrt(sq) + ε); p −= lr·buf. Params fp32 or bf16, the gradients in the
    params' dtype, the state fp32; ``lr`` a number (a tensor is read with
    ``float``)."""
    if _plain(params):
        return rmsprop_step_plain(params, grads, square_avg, momentum_buf, lr, alpha=alpha,
                                  eps=eps, weight_decay=weight_decay, momentum=momentum)
    params, grads, square_avg, momentum_buf = (
        contiguous_leaves(c) for c in (params, grads, square_avg, momentum_buf))
    new = ([torch.empty_like(p) for p in params], [torch.empty_like(s) for s in square_avg],
           [torch.empty_like(b) for b in momentum_buf])
    ptrs, numel, codes = leaf_table("rmsprop_step", (params, grads, square_avg, momentum_buf),
                                    (_PARAM, _PARAM, _STATE, _STATE), new)
    if codes[1] != codes[0]:
        raise ValueError(f"rmsprop_step: the gradients must be in the params' dtype "
                         f"({params[0].dtype}), got {grads[0].dtype}")
    lib = _build.library()
    with _build.on_device(params[0]):
        err = lib.tuk_mt_rmsprop(ptrs.ctypes.data, numel.ctypes.data, len(numel), codes[0],
                                 float(lr), weight_decay, alpha, 1 - alpha, eps, momentum,
                                 int(weight_decay != 0), _build.stream(params[0]))
    _build.check(err, "rmsprop_step")
    _launched(rmsprop_step, len(params))
    return new


grad_sumsq.launches = 0
scale_to_norm.launches = 0
rmsprop_step.launches = 0
