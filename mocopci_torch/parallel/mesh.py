"""Data-parallel layout over ``torch.distributed`` (the port's counterpart of
``mocopci_tpu/parallel/mesh.py``).

One process a device (``torchrun --nproc_per_node N``), every rank on the
data axis: where the JAX package builds a ``("data", "model")`` mesh of
devices, the port counts ranks.  The first ``n_data`` ranks hold rows of the
global batch, contiguous and equal in size; the others hold none and add
zeros to the step's means (``training.loop.dp_train_step``).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def world() -> Tuple[int, int]:
    """(rank, world size) of the running process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh_for_batch(batch_size: int, world_size: Optional[int] = None) -> int:
    """The ranks that hold rows when the global batch is ``batch_size``:
    gcd(batch, world size), so every one of them holds as many rows (the
    reference's global batch 2 on 8 ranks leaves 6 idle)."""
    world_size = world()[1] if world_size is None else world_size
    return max(math.gcd(batch_size, world_size), 1)


def scale_batch_to_mesh(per_device_batch: int,
                        world_size: Optional[int] = None) -> Tuple[int, int]:
    """``--batch_policy per_device``: (global batch, ranks with rows) =
    (per_device_batch x world size, world size).  The learning rate is not
    rescaled."""
    world_size = world()[1] if world_size is None else world_size
    return per_device_batch * world_size, world_size


def host_batch_slice(global_batch: int, n_data: int, rank: Optional[int] = None) -> slice:
    """The rows of the global batch that ``rank`` (default: this process)
    loads and trains on, where the first ``n_data`` ranks hold rows: rank r <
    n_data holds rows [r·B/n_data, (r+1)·B/n_data), the others an empty
    slice."""
    rank = world()[0] if rank is None else rank
    if global_batch % n_data:
        raise ValueError(f"global batch {global_batch} does not split over {n_data} ranks")
    if rank >= n_data:
        return slice(0, 0)
    per = global_batch // n_data
    return slice(rank * per, (rank + 1) * per)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """This rank's own dropout stream (JAX's ``fold_in(rng, axis_index)``):
    rank 0 draws from ``seed`` itself, as the one-device step does; every
    other rank from a seed mixed from (seed, rank)."""
    if rank:
        seed = int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def init_distributed(device: torch.device) -> bool:
    """Joins the process group that ``torchrun`` describes in the environment
    (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``): NCCL for a ``cuda`` device, on card ``LOCAL_RANK``
    (made the current device), gloo for ``cpu``.  A failed start raises;
    nothing falls back to another backend or to one device.  Returns True
    where this call started the group (end it with :func:`shutdown_distributed`),
    False where one runs already or the environment names none."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if device.type == "cuda":
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", init_method="env://", device_id=card)
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


def shutdown_distributed() -> None:
    """Ends the process group, where one runs."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Every rank waits for the others, where a process group runs."""
    if dist.is_initialized():
        dist.barrier()
