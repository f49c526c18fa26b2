"""Build the port's CUDA kernels from ``tpu_unet_torch/csrc`` and load them.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named by a hash of
the sources and flags, under ``tpu_unet_torch/_build/`` (git-ignored). ctypes
loads it. The same idea as ``tpu_unet/native``: build from source at first
use, cache by source hash.

Nothing is built or loaded at import: the first kernel launch calls
:func:`library`, so a machine without ``nvcc`` can import every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# -Xptxas -v writes each kernel's registers, shared memory and spills to the
# build log beside the library.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every exported function: c_void_p for each pointer and the
# stream, so ctypes never truncates them to 32 bits.
_SIGNATURES = {
    "tuk_max_pool2x2": ([_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    "tuk_tc_fused_conv3x3": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                             ctypes.c_int),
    "tuk_tc_fused_conv3x3_f32": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _P], ctypes.c_int),
    "tuk_tc_concat_conv3x3": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P], ctypes.c_int),
    "tuk_tc_im2col_conv3x3": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                               _P], ctypes.c_int),
    "tuk_tc_im2col_conv3x3_f32": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _P], ctypes.c_int),
    "tuk_tc_conv3x3_fwd": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                           ctypes.c_int),
    "tuk_tc_conv3x3_dx": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                          ctypes.c_int),
    "tuk_tc_double_conv": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P], ctypes.c_int),
    "tuk_tc_double_conv_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P], ctypes.c_int),
    "tuk_tc_conv3x3_dw": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P], ctypes.c_int),
    "tuk_tc_conv3x3_fwd_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _P], ctypes.c_int),
    "tuk_tc_conv3x3_dw_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P], ctypes.c_int),
    "tuk_tc_conv3x3_dx_f32": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                              ctypes.c_int),
    "tuk_tc_concat_conv3x3_f32": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _P], ctypes.c_int),
    "tuk_error_string": ([_I], ctypes.c_char_p),
}

# dtype codes of the C interface (csrc/pooling.cu).
DTYPE_F32 = 0
DTYPE_BF16 = 1

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libtuk_{source_hash()}.so"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit "
        "(put nvcc on PATH or set CUDA_HOME)")


def build() -> Path:
    """Compile the sources unless a library for this hash exists; return it.
    One nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = find_nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, cmds, procs = [], [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        cmds.append(cmd)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    results = [(cmd, *p.communicate(), p.returncode) for cmd, p in zip(cmds, procs)]
    tmp = out.with_name(f"{tag}.tmp.so")
    if all(rc == 0 for *_, rc in results):
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        results.append((cmd, proc.stdout, proc.stderr, proc.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(
        " ".join(cmd) + "\n" + so + se for cmd, so, se, _ in results))
    failed = [(cmd, se, rc) for cmd, _, se, rc in results if rc != 0]
    if failed:
        cmd, stderr, rc = failed[0]
        raise RuntimeError(f"nvcc failed with exit code {rc} ({cmd[-1]}):\n{stderr[-6000:]}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().tuk_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")


def validate(kernel: str, *tensors: torch.Tensor) -> int:
    """Check what every kernel needs of its tensor arguments; return the
    dtype code. All on one CUDA device, one dtype (fp32 or bf16), contiguous."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{kernel}: tensors must be on a CUDA device, got {first.device}")
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel}: dtype must be float32 or bfloat16, got {first.dtype}")
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{kernel}: all tensors must share device and dtype "
                             f"({t.device}/{t.dtype} vs {first.device}/{first.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous")
    return DTYPE_BF16 if first.dtype == torch.bfloat16 else DTYPE_F32


def f32_vector(v: torch.Tensor, n: int, like: torch.Tensor, kernel: str) -> torch.Tensor:
    """Per-channel scale or bias as a contiguous fp32 [n] on ``like``'s device
    (the kernels upcast it, as the Pallas wrappers do)."""
    if v.shape != (n,):
        raise ValueError(f"{kernel}: expected a [{n}] vector, got {tuple(v.shape)}")
    return v.to(device=like.device, dtype=torch.float32).contiguous()


def stream(t: torch.Tensor) -> int:
    """The calling thread's current stream on ``t``'s device, as an int: the
    raw handle, as PyTorch's generated kernels take it
    (``torch.cuda.current_stream`` builds a Stream object first, about as
    long on the host as the served pool's whole kernel on the H100)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t: torch.Tensor):
    """A context that makes ``t``'s device current, or none when it is."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)
