"""Multi-host data-parallel training (``tpu_unet/parallel/multihost.py``).

A JAX process owns all of its host's chips, so JAX's process count is its
host count. A port process owns one GPU (``cuda:LOCAL_RANK``), so the
port's "process count" is the world size, and the world spans more than
one host when torchrun's ``WORLD_SIZE`` differs from its
``LOCAL_WORLD_SIZE`` or when explicit flags form a world of
``num_processes > 1`` (one process a host, each on its ``cuda:0`` unless
``LOCAL_RANK`` says otherwise). ``spans_hosts`` is the port's
``jax.process_count() > 1``.

  * ``initialize(coordinator, num_processes, process_id)`` forms the world:
    with explicit arguments ``init_process_group`` over
    ``tcp://<coordinator>``; with none, torchrun's env (``env://``), the
    counterpart of JAX's cluster auto-detect. ``parallel.mesh.
    init_data_parallel`` then joins it.

The input half, JAX's ``MultiHostBatches``, is ``data.prefetch.DataLoader``
with ``shard`` and ``drop_last`` (``train._build_loaders``): every process
draws the same global order (the same seed), loads only its rows of each
global batch from local storage, and drops a trailing partial batch, so
that every process agrees on every batch's shape.

A (data x spatial) grid (``--spatial-parallel``) forms over this world as
over one host's (``parallel.mesh.make_grid``, rank r at d = r // S, s =
r % S: JAX's process-major mesh); each process then loads its data
coordinate's rows and cuts its height band (``DataLoader(shard=, band=)``).
"""

from __future__ import annotations

import logging
from datetime import timedelta

import torch
import torch.distributed as dist

from tpu_unet_torch.parallel.mesh import DataParallelRefused, _env_int

logger = logging.getLogger(__name__)

# The world of an explicit rendezvous (``initialize``): its process group
# and process count, so that ``spans_hosts`` reads them while that group is
# torch.distributed's (process-wide) world; a later world is not it.
_FORMED: dict = {}


def spans_hosts(num_processes: int | None = None) -> bool:
    """Whether the world spans more than one host (JAX's
    ``jax.process_count() > 1``): ``num_processes`` > 1 when given (the
    explicit flags), else the standing world of ``initialize``'s explicit
    rendezvous has more than one process, else torchrun's world is larger
    than its host (``WORLD_SIZE != LOCAL_WORLD_SIZE``)."""
    if num_processes is None and dist.is_initialized() and _FORMED.get("world") is dist.group.WORLD:
        num_processes = _FORMED["num_processes"]
    if num_processes is not None:
        return num_processes > 1
    ws, lws = _env_int("WORLD_SIZE"), _env_int("LOCAL_WORLD_SIZE")
    return ws is not None and lws is not None and ws != lws


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None,
               device: str | torch.device | None = None,
               timeout: timedelta | None = None) -> None:
    """Form the multi-process world. Call it before anything touches a
    device. ``coordinator`` "host:port" with ``num_processes`` and
    ``process_id`` is an explicit rendezvous over TCP; with all three None,
    torchrun's env. The backend is NCCL when ``device`` (default: CUDA if
    present) is a CUDA device, else gloo, unless ``backend`` names one."""
    explicit = coordinator is not None
    if explicit and (num_processes is None or process_id is None):
        raise DataParallelRefused("--coordinator needs --num-processes and --process-id")
    if not explicit and (num_processes is not None or process_id is not None):
        raise DataParallelRefused("--num-processes and --process-id need --coordinator "
                                  "(or launch under torchrun without them)")
    if not explicit and (_env_int("RANK") is None or _env_int("WORLD_SIZE") is None):
        raise DataParallelRefused("--multihost needs torchrun's RANK and WORLD_SIZE (torchrun "
                                  "--nnodes N ...) or --coordinator host:port with "
                                  "--num-processes and --process-id")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK") or 0
        torch.cuda.set_device(local if device.index is None else device.index)
    kw = {"timeout": timeout} if timeout is not None else {}
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if explicit:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=process_id,
                                world_size=num_processes, **kw)
        _FORMED.update(world=dist.group.WORLD, num_processes=num_processes)
    else:
        dist.init_process_group(backend, init_method="env://", **kw)
    logger.info("multihost: process %d/%d (%s), %s", dist.get_rank(), dist.get_world_size(),
                backend, "spans hosts" if spans_hosts() else "one host")


def is_primary() -> bool:
    """True on the process that owns host-side side effects (checkpoint
    writes, W&B): rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
