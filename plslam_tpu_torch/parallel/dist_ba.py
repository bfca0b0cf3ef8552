"""Landmark-sharded Schur-complement bundle adjustment
(``plslam_tpu.parallel.dist_ba``).

Landmarks and their observations are split over the mesh's ranks; every
rank holds all poses.  The solve is ``backend/ba.lm_rounds`` with an
``allsum``: per LM trip each rank assembles its shard's normal equations
and Schur partials (additive over observations; the landmark inverses are
the local BA's, ``schur_partials`` mode "warm"), one collective sums Hcc,
S_off and rhs into the reduced camera system a single device would
assemble, every rank solves it, and the landmark back-substitution stays
local.  The accept/reject test runs on the summed cost.  ``iters`` fixed
trips, no early exit (the JAX ``lax.scan``).
"""

from __future__ import annotations

import functools

from torch.distributed.device_mesh import DeviceMesh

from ..backend import ba as ba_mod
from ..core.camera import StereoCamera
from . import mesh as mesh_mod

AXIS = "lm"

_POSE_FIELDS = ("T_c_w", "pose_fixed", "pose_valid")


def problem_specs(endpoint_lines: bool = False) -> ba_mod.BAProblem:
    """Per field, "replicated" (the poses) or "sharded" (landmarks and
    observations); the endpoint fields are None unless ``endpoint_lines``."""
    none_fields = () if endpoint_lines else ("p_lo", "p_is_line")
    return ba_mod.BAProblem(**{
        f: None if f in none_fields else ("replicated" if f in _POSE_FIELDS else "sharded")
        for f in ba_mod.BAProblem._fields})


def make_dist_bundle_adjust(mesh: DeviceMesh, cam: StereoCamera, cfg: ba_mod.BAConfig,
                            iters: int = 10):
    """The distributed BA over every axis of ``mesh``.  The returned
    function takes this rank's shard (``shard_problem``) and returns
    (problem, cost): the poses and the cost are the same on every rank, the
    landmarks are the rank's."""
    reduce = functools.partial(mesh_mod.allsum, mesh=mesh)
    fixed_trips = cfg._replace(early_exit=False)

    def run(prob: ba_mod.BAProblem):
        out, cost, _ = ba_mod.lm_rounds(prob, cam, fixed_trips, prob.p_valid, prob.l_valid,
                                        iters, allsum=reduce)
        return out, cost

    return run


def shard_problem(mesh: DeviceMesh, prob: ba_mod.BAProblem) -> ba_mod.BAProblem:
    """This rank's shard of ``prob``: its contiguous block of every
    landmark and observation field, the pose fields whole, on the mesh's
    device.  Landmark slot indices (p_lm / l_lm) must already be
    shard-local (host assembly groups observations by landmark shard)."""
    def put(x, spec):
        return mesh_mod.replicate(x if spec == "replicated"
                                  else mesh_mod.shard_leading(x, mesh), mesh)

    specs = problem_specs(prob.p_lo is not None)
    return ba_mod.BAProblem(**{f: None if spec is None else put(getattr(prob, f), spec)
                               for f, spec in zip(ba_mod.BAProblem._fields, specs)})
