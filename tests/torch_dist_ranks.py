"""Rank programs of the distributed tests (``tests/test_torch_dist_*.py``,
``test_torch_multihost.py``, ``test_torch_batch_vo_sharded.py``,
``test_torch_gpu_dist.py``), run by ``plslam_tpu_torch.parallel.launch`` in
gloo rank processes (NCCL for the card's test).  They import torch, numpy,
the port and ``chip_smoke`` only; each takes the launcher's inputs dict and
returns a dict of arrays."""

from __future__ import annotations

import numpy as np
import torch

from plslam_tpu_torch.backend import ba
from plslam_tpu_torch.backend.mapping import MapConfig, MapHandler
from plslam_tpu_torch.convert import ba_problem_from_numpy, pose_graph_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.io.checkpoint import load_map
from plslam_tpu_torch.parallel import dist_ba, dist_gba, dist_match, multihost
from plslam_tpu_torch.parallel.mesh import allgather, allsum, make_mesh, shard_leading


def problem(inputs: dict, prefix: str) -> ba.BAProblem:
    """A BAProblem shipped as ``prefix + field`` arrays."""
    return ba_problem_from_numpy({f: inputs.get(prefix + f) for f in ba.BAProblem._fields}, "cpu")


def run_dist_ba(inputs: dict) -> dict:
    """Landmark-sharded BA of each problem in ``inputs["problems"]`` over a
    1-D "lm" mesh of the world."""
    mesh = make_mesh(axis=dist_ba.AXIS, device_type="cpu")
    cam = StereoCamera.create(*inputs["intrinsics"])
    out = {}
    for name in inputs["problems"]:
        run = dist_ba.make_dist_bundle_adjust(mesh, cam, ba.BAConfig(), inputs[name + "iters"])
        res, cost = run(dist_ba.shard_problem(mesh, problem(inputs, name)))
        out.update({name + "T_c_w": res.T_c_w, name + "cost": cost,
                    name + "points": allgather(res.points, mesh)})
    return out


def run_dist_match_pgo(inputs: dict) -> dict:
    """The sharded matcher on this rank's query block, and the edge-sharded
    PGO of the shipped pose graph."""
    mesh = make_mesh(axis=dist_match.AXIS, device_type="cpu")
    t = {k: torch.from_numpy(inputs[k]) for k in ("dq", "vq", "ddb", "vdb")}
    res = dist_match.make_dist_matcher(mesh, nnr=0.9)(
        shard_leading(t["dq"].view(torch.int32), mesh), shard_leading(t["vq"], mesh),
        t["ddb"].view(torch.int32), t["vdb"])
    g = pose_graph_from_numpy({k[2:]: v for k, v in inputs.items() if k.startswith("g.")}, "cpu")
    got = dist_match.make_dist_pgo(mesh, iters=inputs["pgo_iters"])(
        dist_match.shard_posegraph(mesh, g))
    return {"idx": allgather(res.idx, mesh), "dist": allgather(res.dist, mesh),
            "T_w_k": got.T_w_k}


def _mapper(inputs: dict, key: str) -> MapHandler:
    """A fresh MapHandler on the CPU holding the checkpoint ``inputs[key]``
    (its config in ``inputs[key + "_cfg"]``, its camera in
    ``inputs[key + "_intrinsics"]``, else ``inputs["intrinsics"]``)."""
    intr = inputs.get(key + "_intrinsics", inputs["intrinsics"])
    mapper = MapHandler(StereoCamera.create(*intr, width=752, height=480),
                        MapConfig(**inputs[key + "_cfg"]), device="cpu")
    load_map(inputs[key], mapper)
    return mapper


def _map_arrays(mapper: MapHandler, prefix: str) -> dict:
    mp = mapper.map
    return {prefix + "T_w_k": np.stack([k.T_w_k for k in mp.keyframes]),
            prefix + "pt_w": mp.pt_w.copy(), prefix + "ls_w": mp.ls_w.copy(),
            prefix + "ls_epw": mp.ls_epw.copy(),
            prefix + "pobs_valid": mp.pobs.valid[: mp.pobs.n].copy(),
            prefix + "lobs_valid": mp.lobs.valid[: mp.lobs.n].copy()}


def _partition_arrays(blk: dist_gba.BlockedGBA, prefix: str) -> dict:
    return {prefix + "kf_ids": np.asarray(blk.kf_ids),
            prefix + "block_kfs": np.asarray([len(b) for b in blk.block_kfs]),
            prefix + "block_kf_ids": np.concatenate([np.asarray(b) for b in blk.block_kfs]),
            prefix + "pt_gid": blk.pt_gid, prefix + "own_pt": blk.own_pt,
            prefix + "ls_gid": blk.ls_gid, prefix + "own_ls": blk.own_ls,
            prefix + "p_valid": blk.prob.p_valid}


def run_dist_gba(inputs: dict) -> dict:
    """For each map checkpoint of ``inputs["maps"]``: its partition over
    the world, then the kf-block GBA, routed through
    ``PLSLAM.global_bundle_adjustment(mesh=)``, and the map afterwards."""
    from plslam_tpu_torch.pipeline import PLSLAM

    mesh = make_mesh(axis=dist_gba.AXIS, device_type="cpu")
    out = {}
    for key in inputs["maps"]:
        mapper = _mapper(inputs, key)
        out.update(_partition_arrays(dist_gba.partition_map(mapper, mesh.size()), key + "."))
        slam = PLSLAM.__new__(PLSLAM)
        slam.mapper = mapper
        blk = slam.global_bundle_adjustment(mesh=mesh)
        out[key + ".routed"] = np.asarray(isinstance(blk, dist_gba.BlockedGBA))
        out.update(_map_arrays(mapper, key + "."))
    return out


def run_multihost(inputs: dict) -> dict:
    """On a (2, world / 2) host-major mesh: the mesh's layout, the 2-axis
    and the 1-axis landmark-sharded BA of one problem, and the 2-axis GBA
    of a map checkpoint."""
    mesh2 = multihost.make_multihost_mesh(2, device_type="cpu")
    mesh1 = make_mesh(axis=dist_ba.AXIS, device_type="cpu")
    out = {"coord": np.asarray(mesh2.get_coordinate()),
           "names": np.asarray(mesh2.mesh_dim_names), "shape": np.asarray(mesh2.shape)}
    cam = StereoCamera.create(*inputs["intrinsics"])
    prob = problem(inputs, "toy.")
    for name, mesh in (("2d", mesh2), ("1d", mesh1)):
        run = dist_ba.make_dist_bundle_adjust(mesh, cam, ba.BAConfig(), inputs["iters"])
        res, cost = run(dist_ba.shard_problem(mesh, prob))
        out[name + ".T_c_w"], out[name + ".cost"] = res.T_c_w, cost
    mapper = _mapper(inputs, "map")
    blk = multihost.distributed_gba_2d(mapper, mesh2)
    out["map.n_blocks"] = np.asarray(len(blk.block_kfs))
    out.update(_map_arrays(mapper, "map."))
    return out


def run_batch_vo_sharded(inputs: dict) -> dict:
    """BatchedVisualOdometry(B, sharding=) over a 1-D "seq" mesh of the
    world on (F, B, H, W) left and right stacks: the gathered (B,) result
    of every frame after the first, and whether a batch the world does not
    divide raises."""
    from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.frontend.tracker import TrackerConfig

    mesh = make_mesh(axis="seq", device_type="cpu")
    left, right = torch.from_numpy(inputs["left"]), torch.from_numpy(inputs["right"])
    cam = StereoCamera.create(*inputs["intrinsics"], width=left.shape[-1],
                              height=left.shape[-2])
    fcfg = FrontendConfig(**inputs["fcfg"])
    try:
        BatchedVisualOdometry(left.shape[1] + 1, cam, fcfg, device="cpu", sharding=mesh)
        ragged = False
    except ValueError:
        ragged = True
    bvo = BatchedVisualOdometry(left.shape[1], cam, fcfg, TrackerConfig(), device="cpu",
                                sharding=mesh)
    bvo.initialize(left[0], right[0])
    res = [bvo.gather_result(bvo.process(left[i], right[i])) for i in range(1, left.shape[0])]
    return {"ragged_raises": np.asarray(ragged), "local_B": np.asarray(bvo.B),
            "T_f_w": torch.stack([r.T_f_w for r in res]),
            "good": torch.stack([r.good for r in res]),
            "n_inliers": torch.stack([r.n_inliers for r in res])}


def run_chip_smoke_phase_11(inputs: dict) -> dict:
    """chip_smoke.py's phase 11 (``run_dist``) on this rank at
    ``inputs["cfg"]``'s sizes, on its card (``inputs["device"]`` "cuda") or
    on the CPU: it renders phase 10's first ``cfg["b"]`` streams and
    returns its report lines, launches and program times."""
    import chip_smoke

    cfg = inputs["cfg"]
    dev = (torch.device("cuda", torch.cuda.current_device()) if inputs["device"] == "cuda"
           else torch.device("cpu"))
    streams = [chip_smoke.render_stream(s, cfg["frames"] + 1, cfg["scene"])
               for s in range(cfg["b"])]
    launches, ms, lines = chip_smoke.run_dist(dev, inputs["smi"], streams, cfg)
    return {"lines": np.asarray(lines), "launches": np.asarray(list(launches.values())),
            "ms": np.asarray(list(ms.values())), "ms_names": np.asarray(list(ms))}


def raise_on_rank(inputs: dict) -> dict:
    """Raises on rank ``inputs["rank"]`` after a barrier; the others return."""
    torch.distributed.barrier()
    if torch.distributed.get_rank() == inputs["rank"]:
        raise ValueError(f"rank {inputs['rank']} failed on purpose")
    return {}


def sleep(inputs: dict) -> dict:
    import time

    time.sleep(inputs["seconds"])
    return {}


def reinitialize(inputs: dict) -> dict:
    """Leaves the launcher's group, joins a new one through
    ``multihost.initialize_distributed`` (file://), and sums the ranks over
    a (1, world) ("dcn", "ici") mesh."""
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    torch.distributed.destroy_process_group()
    multihost.initialize_distributed(f"file://{inputs['path']}", world, rank, "cpu")
    mesh = multihost.make_multihost_mesh(1, device_type="cpu")
    return {"shape": np.asarray(mesh.shape),
            "sum": allsum(torch.tensor([float(rank + 1)]), mesh)}
