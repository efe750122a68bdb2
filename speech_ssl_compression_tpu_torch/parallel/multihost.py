"""Multi-process initialisation: ``torch.distributed`` in place of
``jax.distributed``.

Port of ``speech_ssl_compression_tpu/parallel/multihost.py``. Every rank
runs the same program; after :func:`initialize` the trainers build their
``(data, model)`` grid of ranks (``parallel/mesh.py``), each rank reads its
own shard of the data and only the primary (rank 0) writes.

    torchrun --nproc_per_node N -m speech_ssl_compression_tpu_torch.train \\
        ... --multi_host [--model_parallel 2]

:func:`initialize` takes torchrun's ``env://`` variables (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or explicit
arguments (a ``host:port`` coordinator, the process count and this
process's index). The backend is explicit and printed: NCCL where every
rank has a card of its own, gloo on the CPU and for ranks that share one
card (NCCL refuses two ranks on one device). Gloo takes CUDA tensors for
all-reduce and broadcast only, which is all the data and tensor parallel
paths send on the device; host values (lengths, prune scores, checkpoint
shards) travel on a second group, on the CPU, under gloo.

JAX's ``global_batch`` has no counterpart: JAX stitches the processes'
batches into one global array, the port keeps each rank's local batch and
sums the gradients over the data group (``train/parallel_mixin.py``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_STATE = {"cpu_group": None, "backend": None}


def _env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def local_rank() -> int:
    """This process's index on its host: torchrun's ``LOCAL_RANK``; where
    that is unset (an explicit launch, one rank a card), the global rank
    mod this host's card count."""
    n = torch.cuda.device_count()
    rank = process_info()[0]
    return _env_int("LOCAL_RANK", rank % n if n else rank)


def local_world_size() -> Optional[int]:
    """The ranks on this host (torchrun's ``LOCAL_WORLD_SIZE``); None where
    the launch does not say (an explicit launch over several hosts)."""
    return _env_int("LOCAL_WORLD_SIZE")


def default_backend(device_type: str) -> str:
    """NCCL on CUDA where every rank of this host has a card of its own (or
    the launch names no host layout), gloo on the CPU. Ranks that share a
    card have no default: the caller names gloo (``--dist_backend gloo``),
    so that no run switches from NCCL to gloo unasked."""
    if device_type != "cuda":
        return "gloo"
    ranks = local_world_size()
    if ranks is None or torch.cuda.device_count() >= ranks:
        return "nccl"
    raise RuntimeError(
        f"{local_world_size()} ranks on this host share "
        f"{torch.cuda.device_count()} CUDA device(s); NCCL refuses two ranks "
        "on one device: pass --dist_backend gloo (backend='gloo')")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device_type: str = "cuda") -> None:
    """``torch.distributed.init_process_group`` for the launch at hand: the
    explicit arguments (``coordinator_address`` "host:port"), else
    torchrun's env (``WORLD_SIZE`` > 1), else nothing to join and a no-op,
    as in JAX. An explicit multi-process request that fails raises: N
    processes that each believed themselves primary would train N copies.
    ``backend`` defaults to :func:`default_backend` of ``device_type``.
    Calling it again in an initialised process does nothing."""
    if dist.is_initialized():
        return
    explicit = (coordinator_address is not None
                or num_processes not in (None, 1)
                or process_id not in (None, 0))
    env_world = _env_int("WORLD_SIZE", 1)
    if not explicit and env_world <= 1:
        print("[multihost] single-process mode (nothing to join)")
        return
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "a multi-process start needs coordinator_address, "
                "num_processes and process_id together (or torchrun's env)")
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=int(num_processes), rank=int(process_id))
    else:
        init = dict(init_method="env://")
    if backend is None:
        backend = default_backend(device_type)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(backend=backend, **init)
    _STATE["backend"] = backend
    _STATE["cpu_group"] = (dist.group.WORLD if backend == "gloo"
                           else dist.new_group(backend="gloo"))
    rank, world = process_info()
    print(f"[multihost] rank {rank} of {world}, backend {backend} "
          f"(host values on gloo), local rank {local_rank()}", flush=True)


def backend() -> Optional[str]:
    """The backend of the process group, None in single-process mode."""
    return _STATE["backend"] if dist.is_initialized() else None


def cpu_group():
    """The gloo group over every rank that carries host tensors."""
    return _STATE["cpu_group"] if dist.is_initialized() else None


def is_primary() -> bool:
    """True on the process that writes checkpoints, logs and the expdir."""
    return process_info()[0] == 0


def process_info() -> tuple:
    """(rank, world size): (0, 1) in single-process mode."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA run of several
    ranks; where a host has fewer cards than ranks, the ranks share them
    (``LOCAL_RANK`` mod the card count, printed). The CPU stays the CPU."""
    if device.type != "cuda" or process_info()[1] == 1:
        return device
    n = torch.cuda.device_count()
    index = local_rank() % n
    if (local_world_size() or 0) > n:
        print(f"[multihost] {local_world_size()} ranks share {n} card(s): "
              f"rank {process_info()[0]} on cuda:{index}")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)
