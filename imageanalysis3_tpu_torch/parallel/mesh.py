"""Process groups and the 1-D "data" mesh over them.

The counterpart of ``imageanalysis3_tpu/parallel/mesh.py``.  The reference's
only parallelism is an mp.Pool fan-out over hyb rounds
(classes/field_of_view.py:1128-1142); here one process drives one card, the
processes form a ``torch.distributed`` group (NCCL between cards, gloo on
the CPU), and a 1-D ``DeviceMesh`` named "data" spans them.  Collectives
replace file locks: there is no shared mutable state.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

#: how long a collective may wait for its peers before it fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


def _init_group(device_type: str, store, rank, world_size, timeout) -> None:
    if store is None and (rank is not None or world_size is not None):
        raise ValueError("rank and world_size come with a store; without "
                         "one they come from RANK / WORLD_SIZE")
    r = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a CUDA device; pass "
                               "device_type='cpu' for a gloo group")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", r))
                              % torch.cuda.device_count())
    kw = {}
    if store is not None:
        kw = dict(store=store, rank=r,
                  world_size=int(os.environ["WORLD_SIZE"]
                                 if world_size is None else world_size))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            timeout=timeout, **kw)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device_type: str = "cuda", *, store=None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout: datetime.timedelta = DEFAULT_TIMEOUT
              ) -> Optional[DeviceMesh]:
    """1-D mesh named `axis` over the first `n_devices` ranks (default:
    all).

    The process group is initialized here only if none exists: over NCCL
    for ``device_type="cuda"`` (each rank on its card, ``LOCAL_RANK`` or
    the rank modulo the card count), over gloo for ``"cpu"``; from the
    ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
    environment, or from the `store` the caller passes with its `rank` and
    `world_size`.  Every group gets `timeout`.  Every rank of the group
    must call this; a mesh over fewer ranks is returned to its members,
    and the other ranks get None.
    """
    if not dist.is_initialized():
        _init_group(device_type, store, rank, world_size, timeout)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n} not in [1, {world}]")
    group = (dist.group.WORLD if n == world
             else dist.new_group(list(range(n)), timeout=timeout))
    if dist.get_rank() >= n:
        return None
    return DeviceMesh.from_group(group, device_type, mesh_dim_names=(axis,))


def data_sharding(mesh: DeviceMesh, axis: str = "data") -> Tuple[Shard]:
    """The placements that shard the leading (batch) dimension across the
    mesh's `axis`: ``(Shard(0),)``, for ``DTensor.from_local`` /
    ``distribute_tensor``."""
    if mesh.mesh_dim_names != (axis,):
        raise ValueError(f"mesh dims {mesh.mesh_dim_names}, expected "
                         f"({axis!r},)")
    return (Shard(0),)



def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on for `mesh`'s collectives:
    its current card for a CUDA mesh, the CPU for a gloo one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def gather_cat(t: torch.Tensor, mesh: DeviceMesh, dim: int = 0,
               axis: str = "data") -> torch.Tensor:
    """Every rank's `t` (equal shapes), concatenated along `dim` in rank
    order, on every rank (``all_gather``)."""
    if mesh.size() == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)
