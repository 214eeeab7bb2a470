"""Process group and device mesh. Port of `sgs_tpu/parallel/mesh.py`.

`init_distributed` joins the default process group: NCCL on the card, gloo
on the CPU. Under `torchrun` the rank, world size and rendezvous come from
its environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT);
a process started without them forms a one-rank group on a free localhost
port. There is no fallback: if NCCL does not initialise on a CUDA device,
this raises.

`make_mesh` lays ranks out row-major over the named axes
(`torch.distributed.device_mesh.init_device_mesh`); `make_hybrid_mesh`
puts hosts on the "data" axis and each host's ranks on "gauss", so the
record gather of the band render stays inside a host (NVLink) and only
the gradient mean crosses hosts.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from sgs_tpu_torch.core.device import resolve_device


def free_port() -> int:
    """A localhost TCP port that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device: "str | torch.device" = "cuda") -> torch.device:
    """Join the default process group, creating it if needed, and return
    this rank's device (cuda:LOCAL_RANK on the card)."""
    dev = torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        dev = resolve_device(torch.device("cuda", local_rank if dev.index is None else dev.index))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "MASTER_ADDR" in os.environ:
        init_method = "env://"
    elif world == 1:
        init_method = f"tcp://localhost:{free_port()}"
    else:
        raise RuntimeError(f"WORLD_SIZE={world} needs MASTER_ADDR and MASTER_PORT (torchrun sets them)")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this torch has no NCCL: multi-device training on the card needs it")
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                device_id=dev if dev.type == "cuda" else None)
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
    except Exception as exc:
        raise RuntimeError(f"{backend} did not initialise on {dev} (rank {rank} of {world}): {exc}") from exc
    if int(probe.item()) != world:
        raise RuntimeError(f"{backend}: the probe all_reduce gave {probe.item()}, expected {world}")
    return dev


def make_mesh(axis_sizes: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
              device_type: str = "cuda"):
    """A `DeviceMesh` over the first prod(axis_sizes) ranks, row-major; by
    default every rank on the first axis. Raises when the mesh wants more
    ranks than the world has."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    n = math.prod(axis_sizes)
    if n > world:
        raise ValueError(f"mesh wants {n} ranks, have {world}")
    return init_device_mesh(device_type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def hybrid_mesh_shape(world_size: int, local_world_size: int) -> Tuple[int, int]:
    """(hosts, ranks per host): the shape of the hybrid mesh for a world of
    `world_size` ranks, `local_world_size` on each host."""
    if local_world_size <= 0 or world_size % local_world_size:
        raise ValueError(f"{world_size} ranks do not split into hosts of {local_world_size}")
    return world_size // local_world_size, local_world_size


def make_hybrid_mesh(device_type: str = "cuda"):
    """The (hosts, local ranks) mesh from torchrun's WORLD_SIZE and
    LOCAL_WORLD_SIZE: "data" spans hosts, "gauss" each host's ranks."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    return make_mesh(hybrid_mesh_shape(world, local), ("data", "gauss"), device_type)


def axis(mesh, name: str) -> Tuple["dist.ProcessGroup", int, int]:
    """(process group, this rank's index, size) of one mesh axis."""
    return mesh.get_group(name), mesh.get_local_rank(name), mesh.size(mesh.mesh_dim_names.index(name))
