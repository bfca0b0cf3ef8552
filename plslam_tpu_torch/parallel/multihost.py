"""Multi-host (DCN x ICI) meshes for the distributed solvers
(``plslam_tpu.parallel.multihost``).

The same programs as ``dist_ba`` and ``dist_gba`` run on a 2-axis
``(host, device)`` mesh: "dcn" is the slow cross-host axis, "ici" the fast
axis within a host.  Shards run over both axes, host-major, and every
reduction runs over "ici" first and then over "dcn" on the reduced data
(``mesh.allsum``).  Each process calls ``initialize_distributed`` once;
the mesh lays the world out as ``(n_hosts, devices_per_host)`` with ranks
``h * devices_per_host + d``, so ranks 0..devices_per_host-1 form host 0.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import dist_ba, dist_gba, mesh as mesh_mod

DCN_AXIS = "dcn"
ICI_AXIS = "ici"
AXES = (DCN_AXIS, ICI_AXIS)


def initialize_distributed(init_method: str = "env://", world_size: int | None = None,
                           rank: int | None = None, device_type: str = "cuda") -> None:
    """Join the process group: NCCL for ``device_type="cuda"`` (this rank's
    card is ``LOCAL_RANK``), gloo for ``"cpu"``.  ``init_method`` is
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``)
    or ``file://`` a path every rank can reach; ``world_size`` and
    ``rank`` default to the environment's."""
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(mesh_mod._BACKEND[device_type], init_method=init_method, **kw)


def make_multihost_mesh(n_hosts: int | None = None, devices_per_host: int | None = None,
                        device_type: str = "cuda") -> DeviceMesh:
    """The host-major ``(n_hosts, devices_per_host)`` mesh named ("dcn",
    "ici") over the world.  ``devices_per_host`` defaults to the world over
    ``n_hosts``, else to ``LOCAL_WORLD_SIZE`` (the launcher's ranks per
    host), else to the world; ``n_hosts`` to the world over it."""
    world = dist.get_world_size()
    if devices_per_host is None:
        devices_per_host = (world // n_hosts if n_hosts
                            else int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    n_hosts = n_hosts or world // devices_per_host
    return mesh_mod.make_mesh(device_type=device_type, shape=(n_hosts, devices_per_host),
                              names=AXES)


# The 2-axis programs are the 1-axis ones on a 2-axis mesh: shards and
# reductions run over every axis of the mesh they are given.
make_dist_bundle_adjust_2d = dist_ba.make_dist_bundle_adjust
shard_problem_2d = dist_ba.shard_problem
distributed_gba_2d = dist_gba.distributed_global_bundle_adjustment
