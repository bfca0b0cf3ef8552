"""Sharded feature matching and edge-sharded pose-graph optimization
(``plslam_tpu.parallel.dist_match``).

- Matching: query descriptors are split over the ranks, the database is
  whole on every rank.  Each rank computes its block of the Hamming matrix
  (the card's kernel, through the ``cuda_hamming`` operator) and its rows'
  best and second best; the mutual check needs each column's best row over
  all the queries: an ``allmin`` of the (distance, global row) pairs packed
  into int64.  The JAX package packs with ``astype(jnp.int64)``, which
  without x64 truncates to int32: a masked pair (2^20 << 20) then wraps to
  its bare row and wins its column.  Here the packing is real int64.
- Pose graph: edges are split over the ranks, poses whole; each rank sums
  its edges' blocks (``backend/pgo.build_system``), one ``allsum`` gives
  the full Gauss-Newton system, and every rank solves it (float64).
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..backend import pgo as pgo_mod
from ..ops.cuda_hamming import hamming_distance_matrix
from ..ops.matching import BIG, MatchResult, _top2_min
from . import mesh as mesh_mod

AXIS = "lm"
_ROW_BITS = 20


def make_dist_matcher(mesh: DeviceMesh, nnr: float = 0.9):
    """The sharded mutual-NNR matcher.  The returned function takes this
    rank's query block (desc (n, 8) int32, valid (n,)) and the whole
    database (desc (M, 8), valid (M,)), and returns this block's
    ``MatchResult`` (``ops.matching.match_mutual_nnr``'s contract)."""

    def run(desc_q, valid_q, desc_db, valid_db) -> MatchResult:
        n_local = desc_q.shape[0]
        if n_local * mesh.size() > 1 << _ROW_BITS:
            raise ValueError(f"dist matcher: more than 2^{_ROW_BITS} query rows")
        d = torch.where(valid_q[:, None] & valid_db[None, :],
                        hamming_distance_matrix(desc_q.contiguous(), desc_db.contiguous()), BIG)
        best, second, arg = _top2_min(d)
        ok = (best < BIG) & (best.to(torch.float32) < nnr * second.to(torch.float32))
        row = mesh_mod.shard_index(mesh) * n_local + torch.arange(
            n_local, dtype=torch.int64, device=d.device)
        packed = (d.to(torch.int64) << _ROW_BITS) + row[:, None]
        col_best = mesh_mod.allmin(packed.amin(dim=0), mesh)
        ok = ok & ((col_best & ((1 << _ROW_BITS) - 1))[arg] == row)
        return MatchResult(idx=torch.where(ok, arg, -1).to(torch.int32),
                           dist=torch.where(ok, best, BIG).to(torch.int32))

    return run


def make_dist_pgo(mesh: DeviceMesh, iters: int = 10, damping: float = 1e-6):
    """Edge-sharded Gauss-Newton: the returned function takes a
    ``PoseGraph`` holding all poses and this rank's edges
    (``shard_posegraph``) and returns it with the optimized poses, the same
    on every rank."""
    reduce = functools.partial(mesh_mod.allsum, mesh=mesh)
    return functools.partial(pgo_mod.optimize, iters=iters, damping=damping, allsum=reduce)


_EDGE_FIELDS = ("e_i", "e_j", "e_T", "e_info", "e_valid")


def shard_posegraph(mesh: DeviceMesh, g: pgo_mod.PoseGraph) -> pgo_mod.PoseGraph:
    """Poses whole, this rank's block of the edges (pad the edge count to
    a multiple of the shards with e_valid=False rows), on the mesh's
    device."""
    return pgo_mod.PoseGraph(**{
        f: mesh_mod.replicate(mesh_mod.shard_leading(getattr(g, f), mesh)
                              if f in _EDGE_FIELDS else getattr(g, f), mesh)
        for f in pgo_mod.PoseGraph._fields})
