"""Device meshes over the initialized torch.distributed world (port of
qtpu/sharding/mesh.py).

Axes as in qtpu: `data` (calibration rows, eval blocks, serving batch rows)
x `model` (Megatron tensor-parallel weight shards and KV-cache heads). A
mesh is a torch DeviceMesh with named dims; the sharded paths take one of
its dims' process groups (`local_group`) and run explicit collectives
(qtpu_torch.sharding.collectives) on plain tensors.

The world comes first: `qtpu_torch.sharding.multihost.initialize_multihost`
(or torchrun's environment). The mesh's device type follows the world's
backend: "cuda" under NCCL, "cpu" under gloo (gloo ranks may share one
card; their tensors stay on it, and the collectives stage what gloo does
not take).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(shape, names, device_type: str | None = None) -> DeviceMesh:
    """A DeviceMesh of `shape` over the first prod(shape) ranks of the world."""
    n = 1
    for s in shape:
        n *= s
    have = world_size()
    if n > have:
        dims = "x".join(str(s) for s in shape)
        raise ValueError(f"mesh {dims} needs {n} devices, have {have}")
    if not dist.is_initialized():
        raise ValueError("a mesh needs an initialized torch.distributed world "
                         "(qtpu_torch.sharding.multihost.initialize_multihost)")
    ranks = torch.arange(n).reshape(*shape)
    return DeviceMesh(device_type or mesh_device_type(), ranks, mesh_dim_names=tuple(names))


def make_mesh(data: int = -1, model: int = 1, device_type: str | None = None) -> DeviceMesh:
    """Build a ('data', 'model') mesh. data=-1 takes the ranks that are left."""
    n = world_size()
    if model <= 0:
        model = 1
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    return build_mesh((data, model), ("data", "model"), device_type)


def axis_size(mesh, name: str) -> int:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate on the mesh dim `name` (0 without it)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def local_group(mesh, name: str):
    """The process group of this rank's mesh dim `name`, or None when there
    is no mesh or no such dim (a group of one is returned as a group, so a
    one-rank world runs the same collectives)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(name)
