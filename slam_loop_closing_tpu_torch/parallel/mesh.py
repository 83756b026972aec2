"""The process group every sharded stage runs on, and its tensor helpers.

Port of :mod:`slam_loop_closing_tpu.parallel.mesh`. The JAX package's mesh
is a 1-D ``jax.sharding.Mesh`` of devices in one program; here it is a
``torch.distributed`` process group of ranks, one device a rank:

* :func:`make_mesh` joins the process group if one is initialised (for
  example by ``torchrun`` or :func:`.launch.spawn`), else starts a 1-rank
  group on an in-process store (no network). A CUDA device gets NCCL or an
  error; gloo serves only a caller that asks for ``device="cpu"``.
* The sharded functions take the global inputs on every rank and give every
  rank the global outputs, as the JAX functions return global arrays:
  :func:`shard_leading` cuts this rank's rows, :func:`gather_leading`
  all-gathers the rows back, :func:`replicated` broadcasts rank 0's tensor.

Collectives run on ``bool`` tensors as ``uint8`` views (one byte either
way), so every backend takes them.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D mesh: its process group, rank, the group's
    size and the device its tensors live on."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device

    def peer(self, offset: int) -> int:
        """Global rank of the member ``offset`` places along the ring."""
        return dist.get_global_rank(self.group,
                                    (self.rank + offset) % self.size)


def _backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, which this torch "
                               "build lacks")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no mesh backend for device {device}")


def make_mesh(num_devices: int = 0, *, device="cuda") -> Mesh:
    """The mesh of this process: the initialised default process group,
    else a new 1-rank group on a ``HashStore``. ``num_devices`` (0 = all)
    must equal the group's size. On a CUDA device the group's backend must
    be NCCL, and a device without an index becomes the visible GPU
    ``LOCAL_RANK`` (else the rank's number); raises if NCCL is missing or
    fewer GPUs are visible than asked. On ``device="cpu"`` the backend is
    gloo."""
    device = torch.device(device)
    backend = _backend_for(device)
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if visible < max(num_devices, 1):
            raise RuntimeError(f"{max(num_devices, 1)} GPUs asked, "
                               f"{visible} visible")
    if not dist.is_initialized():
        if num_devices > 1:
            raise ValueError(f"a mesh of {num_devices} ranks needs a launcher "
                             "(torchrun or parallel.launch.spawn); without "
                             "one the mesh has one rank")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, a "
                           f"{device.type} mesh needs {backend}")
    group = dist.group.WORLD
    rank, size = dist.get_rank(), dist.get_world_size()
    if num_devices and num_devices != size:
        raise ValueError(f"{num_devices} ranks asked, the process group has "
                         f"{size}")
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            if local >= torch.cuda.device_count():
                raise RuntimeError(f"rank {rank} has no GPU of its own: "
                                   f"{torch.cuda.device_count()} visible")
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    return Mesh(group=group, rank=rank, size=size, device=device)


def _comm(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives see it: bool as a uint8 view."""
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def pad_to_multiple(x: torch.Tensor, m: int, axis: int = 0):
    """Pad ``axis`` with zeros to a multiple of ``m`` (the even-shard
    requirement). Returns (padded, original_size)."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n


def shard_leading(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the leading axis of the global ``x`` (divisible
    by the mesh size), on the mesh's device."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"leading axis {n} does not split over "
                         f"{mesh.size} ranks; pad first")
    per = n // mesh.size
    return torch.as_tensor(x[mesh.rank * per:(mesh.rank + 1) * per]).to(
        mesh.device)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` on the mesh's device, equal on every rank: rank 0's tensor,
    broadcast."""
    out = torch.as_tensor(x).to(mesh.device, copy=True).contiguous()
    dist.broadcast(_comm(out), dist.get_global_rank(mesh.group, 0),
                   group=mesh.group)
    return out


def gather_leading(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) stacked along the leading axis in
    rank order, on every rank: the global tensor of a sharded one."""
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(_comm(out), _comm(x), group=mesh.group)
    return out


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``, in place, on every rank."""
    dist.all_reduce(x, dist.ReduceOp.SUM, group=mesh.group)
    return x


def all_reduce_max(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The largest of every rank's ``x``, in place, on every rank."""
    dist.all_reduce(x, dist.ReduceOp.MAX, group=mesh.group)
    return x


def sum_reduction(mesh: Mesh):
    """The reduction :func:`..ops.pgo.optimize_pose_graph` and
    :func:`..ops.ba.alternating_ba` apply to each partial sum of a shard:
    :func:`all_reduce_sum` over the mesh."""
    return lambda x: all_reduce_sum(mesh, x.contiguous())
