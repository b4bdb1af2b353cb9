"""Multi-card proving: process-group init, the device mesh, batch
sharding.  Counterpart of `davinci_tpu/parallel/mesh.py`.

The reference is single-controller: one process drives a
`jax.sharding.Mesh` and `shard_map` splits global arrays over it.  The
port is SPMD on `torch.distributed`: one process per card, every rank
calling the same entry point (`Groth16.prove` after `set_mesh`, or
`sharded_msm` / `DeviceNTT.sharded_ntt`) on the same inputs, each rank
holding only its block of the sharded data.  A mesh is a one-dimensional
`DeviceMesh` over the world; the row collectives below run on
`mesh.get_group(axis_name)`: NCCL between cards, gloo between CPU
processes.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def distributed_init(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    timeout: float | None = None,
):
    """Join the process group (`tcp://host:port` or `file:///path`).  A
    no-op when init_method is None, as the reference's is without a
    coordinator.  The backend defaults to NCCL where CUDA is available and
    gloo otherwise; timeout, in seconds, bounds the rendezvous and every
    collective."""
    if init_method is None:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)


def get_mesh(axis_name: str = "shard", device="cuda"):
    """A one-dimensional DeviceMesh over the whole world, its one dim
    named axis_name."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type,
                            (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def axis_size(mesh, axis_name: str = "shard") -> int:
    return dist.get_world_size(mesh.get_group(axis_name))


def axis_rank(mesh, axis_name: str = "shard") -> int:
    return dist.get_rank(mesh.get_group(axis_name))


def shard_batch(mesh, arr, axis_name: str = "shard"):
    """This rank's contiguous block of an (n, ...) array's leading dim.
    n must divide evenly over the axis, as jax's NamedSharding needs."""
    D = axis_size(mesh, axis_name)
    n = arr.shape[0]
    if n % D:
        raise ValueError(f"{n} rows do not split evenly over {D} ranks")
    b = n // D
    r = axis_rank(mesh, axis_name)
    return arr[r * b:(r + 1) * b]


def all_gather_rows(mesh, x, axis_name: str = "shard"):
    """Every rank's x concatenated along the leading dim in rank order:
    (D * n, ...) from (n, ...), the inverse of `shard_batch`."""
    group = mesh.get_group(axis_name)
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_rows(mesh, x, axis_name: str = "shard"):
    """The sum over the ranks of x (D * n, ...), of which this rank keeps
    its block (n, ...)."""
    group = mesh.get_group(axis_name)
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def all_to_all_rows(mesh, x, axis_name: str = "shard"):
    """x (D * n, ...) split into D blocks, block d sent to rank d; the
    result holds the block each rank sent here, in rank order."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.get_group(axis_name))
    return out


def broadcast_objects(mesh, values: list, axis_name: str = "shard") -> list:
    """The axis's first rank's picklable values, on every rank."""
    group = mesh.get_group(axis_name)
    values = list(values)
    dist.broadcast_object_list(values, src=dist.get_global_rank(group, 0),
                               group=group)
    return values
