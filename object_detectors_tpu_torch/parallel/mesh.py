"""Data parallelism over processes with ``torch.distributed`` (the
counterpart of the JAX package's ``parallel/mesh.py``, which jits one SPMD
program over a device mesh).

The reference runs one process per GPU with NCCL DDP
(`yolo/procedures/initialize.py:47-51`, `detection/train.py:159-161`) and
all-reduces the logged losses (`yolo/main.py:95-96`); so does the port:
one process a card, launched by ``torchrun``, each loading its shard of
the data (``process_index`` / ``process_count`` feed the batch iterators
as ``jax.process_index`` / ``jax.process_count`` do in JAX). The global
batch is the configured batch size, split evenly over the processes.

Batch norm: JAX reduces batch statistics over the global batch. Above one
process ``models/common.py:ConvBN`` takes the data-parallel batch norm of
``parallel/batch_norm.py``, which all-reduces its sums forward and
backward; nothing else trains on batch statistics.

Loss normalizers: JAX divides a sum over the global batch by a count over
it. Each rank divides its own sum by the count over all processes
(``global_sum``) and scales the quotient by the number of processes
(``rank_share``), so that DDP's mean of the ranks' gradients, and
``all_reduce_mean`` of their losses, are JAX's. In one process both are the
identity.
"""

from __future__ import annotations

import os

import torch
from torch import nn


def _initialized() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def maybe_initialize_distributed(init_method: str | None = None) -> None:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL where a GPU is visible (each process on the card
    of its ``LOCAL_RANK``), gloo on the CPU. A no-op when already
    initialized, and for one process unless ``init_method`` (a
    ``torch.distributed`` URL such as ``file:///tmp/pg``) is given."""
    if _initialized():
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 and init_method is None:
        return
    rank = int(os.environ.get("RANK", "0"))
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    torch.distributed.init_process_group("nccl" if cuda else "gloo",
                                         init_method=init_method or "env://",
                                         rank=rank, world_size=world)


def process_index() -> int:
    return torch.distributed.get_rank() if _initialized() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if _initialized() else 1


def data_parallel_size(batch_size: int, processes: int | None = None) -> int:
    """The largest divisor of ``batch_size`` that fits ``processes`` (default:
    the world size): the data axis of the JAX ``make_mesh_for_batch``."""
    avail = process_count() if processes is None else processes
    return max(d for d in range(1, avail + 1) if batch_size % d == 0)


def per_process_batch(batch_size: int) -> int:
    """The batch each process loads: ``batch_size`` split evenly over the
    processes. Raises where it does not split (JAX would leave devices idle;
    a process launched by ``torchrun`` cannot be left out)."""
    world = process_count()
    if data_parallel_size(batch_size, world) != world:
        raise ValueError(f"a batch of {batch_size} does not split over {world} processes")
    return batch_size // world


def data_parallel(model: nn.Module) -> nn.Module:
    """``model`` for data-parallel training: above one process it is wrapped
    in ``DistributedDataParallel``, which starts every rank from rank 0's
    parameters and buffers; in one process it is returned unchanged. The
    buffers are not broadcast again at each forward: the batch norms'
    running statistics move by the global statistics on every rank alike,
    and an evaluation forward then issues no collective."""
    if process_count() <= 1:
        return model
    device = next(model.parameters()).device
    ids = [device.index] if device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(model, device_ids=ids, broadcast_buffers=False)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of the detached ``x`` over the processes (a SUM all-reduce of
    a copy); ``x`` itself in one process."""
    if process_count() <= 1:
        return x
    x = x.detach().clone()
    torch.distributed.all_reduce(x)
    return x


def rank_share(x: torch.Tensor) -> torch.Tensor:
    """A rank's sum over a global count, times the number of processes:
    DDP averages the ranks' gradients, and the mean of the ranks' shares is
    then the global sum over the global count, as JAX computes it; ``x``
    itself in one process."""
    world = process_count()
    return x if world <= 1 else x * world


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the processes (for logged metrics); ``x``
    itself in one process."""
    if process_count() <= 1:
        return x
    x = x.detach().clone()
    torch.distributed.all_reduce(x)
    return x / process_count()
