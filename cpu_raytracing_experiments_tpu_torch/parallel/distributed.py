"""Multi-process scaffolding over ``torch.distributed``, the port of the JAX
package's ``parallel/distributed.py``.

One process drives one device; ``initialize`` joins the processes into one
group and the mesh builders lay them out as a ('dp', 'sp') ``DeviceMesh``
that keeps the pixel axis (``dp``) inside a node and the sample axis
(``sp``) across nodes: rendering is embarrassingly parallel across sample
shards, so the slow interconnect only ever carries the one-off bucket merge
at resolve time (SURVEY.md section 5: distributed communication backend
slot). Nothing here discovers a cluster: the caller names the rendezvous
(``init_method``, e.g. ``tcp://host:port`` or ``file:///path``), the world
size and the rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def default_backend(device_type: str) -> str:
    """NCCL for CUDA tensors, gloo for the CPU's."""
    return "nccl" if device_type == "cuda" else "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None):
    """``torch.distributed.init_process_group`` (JAX
    ``jax.distributed.initialize`` passthrough), the one place a process
    group is made. Without a rendezvous and for one process, the group is
    world size 1 over an in-process store. The backend is NCCL where a CUDA
    device is available and gloo otherwise, unless `backend` names one."""
    backend = backend or default_backend(
        "cuda" if torch.cuda.is_available() else "cpu")
    if init_method is None and world_size in (None, 1):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def group_size() -> int:
    """The number of processes of the group ``initialize`` made."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call distributed.initialize() "
                           "first")
    return dist.get_world_size()


def mesh_2d(dp: int, sp: int, device_type: str = "cuda"):
    """The ('dp', 'sp') ``DeviceMesh`` of dp x sp processes: rank
    ``dp_i * sp + sp_i`` sits at (dp_i, sp_i), as the JAX package's
    ``devices.reshape(dp, sp)`` lays devices out. A group of one process
    is the 1 x 1 mesh; without a group it raises."""
    from torch.distributed.device_mesh import init_device_mesh

    world = group_size()
    if dp * sp != world:
        raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} processes, "
                         f"not {world}")
    return init_device_mesh(device_type, (dp, sp),
                            mesh_dim_names=("dp", "sp"))


def pod_mesh(sp: int = 1, device_type: str = "cuda"):
    """Global ('dp', 'sp') mesh over every process of the group, `sp`
    groups contiguous in rank order so each sample shard maps to a
    contiguous slice of ranks (dp collectives stay local, only sp crosses
    nodes)."""
    world = group_size()
    if world % sp:
        raise ValueError(f"sp={sp} does not divide {world} processes")
    return mesh_2d(world // sp, sp, device_type)


def multi_slice_mesh(num_slices: int, device_type: str = "cuda"):
    """One sample shard per slice (node): dp spans a slice's devices, sp
    spans slices."""
    return pod_mesh(sp=num_slices, device_type=device_type)
