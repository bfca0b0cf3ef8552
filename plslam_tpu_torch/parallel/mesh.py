"""Device meshes, shards and the collectives of the distributed solvers
(``plslam_tpu.parallel.mesh``).

The SLAM-domain sharding map: landmarks (the "lm" axis) are the data-parallel
dimension of bundle adjustment, keyframe blocks ("kf") that of the global
BA, edges that of the pose graph, streams ("seq") that of batched VO.  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the whole
world: ``"cuda"`` runs on NCCL, ``"cpu"`` on gloo, and the device type
must match the backend of the process group (no silent fallback to the
CPU).  Each rank holds the same host inputs and takes its contiguous block
of a sharded leading axis, which runs over every axis of the mesh, outer
axis major; ``allsum``/``allmin`` stand where the JAX package's
``shard_map`` programs call ``psum``/``pmin``.  Over a 2-axis mesh a
reduction runs over the inner axis first ("ici", within a host) and then
over the outer one ("dcn", across hosts) on the reduced data.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(axis: str = "lm", device_type: str = "cuda",
              shape: tuple[int, ...] | None = None,
              names: tuple[str, ...] | None = None) -> DeviceMesh:
    """A mesh over the initialized process group: 1-D over the world named
    ``axis``, or ``shape`` named ``names``, ranks laid out in row-major
    order.  It covers the whole world; ``device_type`` must match the
    group's backend."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: init_process_group first")
    backend = dist.get_backend()
    if _BACKEND.get(device_type) != backend:
        raise ValueError(f"make_mesh: device_type {device_type!r} needs the "
                         f"{_BACKEND.get(device_type)} backend, the process group runs {backend}")
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (world,)
    names = tuple(names) if names is not None else (axis,)
    size = 1
    for s in shape:
        size *= s
    if size != world or len(names) != len(shape):
        raise ValueError(f"make_mesh: shape {shape} named {names} must cover the world of "
                         f"{world} ranks")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape), mesh_dim_names=names)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's tensors on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_index(mesh: DeviceMesh) -> int:
    """This rank's position over the mesh's axes, outer axis major (the
    JAX ``axis_index`` of a spec over every axis)."""
    idx = 0
    for d, c in enumerate(mesh.get_coordinate()):
        idx = idx * mesh.size(d) + c
    return idx


def shard_leading(x, mesh: DeviceMesh):
    """This rank's contiguous block of the leading axis of ``x`` (a tensor
    or numpy array), which must divide evenly over the mesh's ranks."""
    n, i = mesh.size(), shard_index(mesh)
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} does not divide over {n} shards")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def replicate(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``x`` (a whole field, or this rank's shard of one) on this rank's
    device."""
    return x.to(mesh_device(mesh))


def _allreduce(x: torch.Tensor, mesh: DeviceMesh, op) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    for d in reversed(range(mesh.ndim)):            # inner axis first
        dist.all_reduce(y, op=op, group=mesh.get_group(d))
    return y


def allsum(x, mesh: DeviceMesh):
    """Sum over the mesh's ranks (psum) of a float tensor, or of a tuple of
    them in one collective; new tensors.  They are summed in float64 and
    rounded once, as ``core/segment.py`` sums rows: the ranks' order of
    additions then moves an f32 result by less than an ulp."""
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    flat = _allreduce(torch.cat([t.reshape(-1).to(torch.float64) for t in xs]), mesh,
                      dist.ReduceOp.SUM)
    out = [part.view(t.shape).to(t.dtype)
           for part, t in zip(flat.split([t.numel() for t in xs]), xs)]
    return out[0] if isinstance(x, torch.Tensor) else tuple(out)


def allmin(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Elementwise minimum over the mesh's ranks (pmin)."""
    return _allreduce(x, mesh, dist.ReduceOp.MIN)


def allgather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``x``, concatenated on the leading axis in shard order
    (the inverse of ``shard_leading``)."""
    y = x.contiguous()
    is_bool = y.dtype == torch.bool
    if is_bool:
        y = y.to(torch.uint8)
    for d in reversed(range(mesh.ndim)):            # inner axis first
        g = mesh.get_group(d)
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, y, group=g)
        y = torch.cat(parts)
    return y.to(torch.bool) if is_bool else y
