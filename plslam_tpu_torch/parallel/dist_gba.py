"""Keyframe-block sharded global bundle adjustment
(``plslam_tpu.parallel.dist_gba``).

The map's landmarks are split into landmark-disjoint chunks, sorted by the
keyframe block that holds most of their observations (locality only), and
the chunks are dealt to the ranks in contiguous runs.  Every chunk carries
all observations of its landmarks against the whole pose table, so the
chunks' Schur partials sum to the reduced camera system of the chunked GBA
(``backend/ba.bundle_adjust_chunked``; mapHandler.cpp:3022-3126): no
consensus rounds.  Every rank gathers every chunk's partials and costs and
sums them in chunk order, so the result is that of
``bundle_adjust_chunked`` in one process on the same partition, bit for
bit, whatever the world size.  (An all-reduce of per-rank sums adds in
another order, and the f32 solve of an endpoint-line map moves by
millimetres with the order of its sums.)  Every rank gathers every chunk's
result and writes the whole map back, so the ranks' maps stay identical.

Both line parameterizations: Pluecker lines ride the chunk's line table,
endpoint lines the chunk's point table as endpoint pairs.
"""

from __future__ import annotations

import functools
import logging
from typing import NamedTuple

import numpy as np
from torch.distributed.device_mesh import DeviceMesh

from ..backend import ba as ba_mod
from ..backend.mapping import _orth_from_plucker_meta, _pad_bucket
from ..convert import ba_problem_from_numpy
from ..core.camera import StereoCamera
from . import mesh as mesh_mod

log = logging.getLogger("plslam.dist_gba")

AXIS = "kf"
_POSE_FIELDS = ("T_c_w", "pose_fixed", "pose_valid")


class BlockedGBA(NamedTuple):
    """Host-assembled inputs: chunk problems stacked on a leading axis
    (n_chunks = n_blocks * chunks per rank), pose fields unstacked."""

    prob: ba_mod.BAProblem          # numpy chunk fields (n_chunks, ...), poses flat
    metas: list                     # per-chunk _assemble_problem meta dicts
    kf_ids: list                    # pose slot s <-> keyframe kf_ids[s]
    block_kfs: list                 # per-rank keyframe id lists (locality)
    pt_ids_glob: np.ndarray         # (Ng,) map row of each global point slot
    ls_ids_glob: np.ndarray         # (Lg,)
    pt_gid: np.ndarray              # (n_chunks, cap_pts) global slot (-1 pad);
    #                                 endpoint mode: endpoint rows get
    #                                 Ng + 2*line(+1)
    own_pt: np.ndarray              # (n_chunks, cap_pts) slot is optimized here
    ls_gid: np.ndarray              # (n_chunks, cap_ls)
    own_ls: np.ndarray              # (n_chunks, cap_ls)
    plucker: bool                   # line parameterization of the chunks


def partition_map(mapper, n_blocks: int) -> BlockedGBA:
    """Split the map's landmarks into landmark-disjoint, owner-block-sorted
    chunks (n_blocks ranks x C chunks each) and assemble one padded numpy
    BAProblem per chunk over all active keyframes.  Each landmark lies in
    exactly one chunk with every one of its observations.  Host numpy
    only, the same on every rank."""
    mp = mapper.map
    cfg = mapper.cfg
    plucker = cfg.plucker_lines
    kf_ids = [k.id for k in mp.keyframes if k.active]
    blocks = np.array_split(np.asarray(kf_ids), n_blocks)
    block_of_kf = np.zeros(len(mp.keyframes), np.int64)
    for b, ids in enumerate(blocks):
        block_of_kf[ids] = b

    allmask = np.zeros(len(mp.keyframes), bool)
    allmask[kf_ids] = True
    pt_ids, ls_ids = mapper._ba_landmark_ids(allmask)
    Ng = len(pt_ids)
    g_of_pt = np.full(mp.n_pt, -1, np.int64)
    g_of_pt[pt_ids] = np.arange(Ng)
    g_of_ls = np.full(mp.n_ls, -1, np.int64)
    g_of_ls[ls_ids] = np.arange(len(ls_ids))

    # owner block = argmax of per-block observation counts: a sort key for
    # locality only, since every chunk carries all of its observations
    def owner(tb, n_lm, ids):
        sel = tb.valid[: tb.n] & allmask[tb.kf[: tb.n]]
        cnt = np.zeros((n_lm, n_blocks), np.int64)
        np.add.at(cnt, (tb.lm[: tb.n][sel], block_of_kf[tb.kf[: tb.n][sel]]), 1)
        return cnt[ids].argmax(axis=1) if len(ids) else np.zeros(0, np.int64)

    pt_sorted = pt_ids[np.argsort(owner(mp.pobs, mp.n_pt, pt_ids), kind="stable")]
    ls_sorted = ls_ids[np.argsort(owner(mp.lobs, mp.n_ls, ls_ids), kind="stable")]

    # the single-device GBA's per-chunk capacities; C chunks per rank, the
    # fewest that fit them
    cap_p, cap_l, cap_p_eff, cap_l_eff = mapper._gba_chunk_caps()
    C = max(1, -(-Ng // (n_blocks * cap_p_eff)), -(-len(ls_ids) // (n_blocks * cap_l_eff)))
    n_chunks = n_blocks * C
    pt_chunks = np.array_split(pt_sorted, n_chunks)
    ls_chunks = np.array_split(ls_sorted, n_chunks)
    cap_k = _pad_bucket(len(kf_ids), lo=8)

    probs, metas = [], []
    gids_p, owns_p, gids_l, owns_l = [], [], [], []
    for pc, lc in zip(pt_chunks, ls_chunks):
        prob, meta = mapper._assemble_problem(kf_ids, pc, lc, cap_p, cap_l, cfg.ba_pobs,
                                              cfg.ba_lobs, fix_rule="kf0", cap_k=cap_k)
        prob = _orth_from_plucker_meta(prob, meta)
        gp = np.full(cap_p, -1, np.int64)
        gp[: len(pc)] = g_of_pt[pc]
        op = np.zeros(cap_p, bool)
        op[: len(pc)] = True
        gl = np.full(cap_l, -1, np.int64)
        ol = np.zeros(cap_l, bool)
        if plucker:
            gl[: len(lc)] = g_of_ls[lc]
            ol[: len(lc)] = True
        elif len(lc):
            # endpoint rows of the point table, owned with their line
            sl = np.arange(len(lc))
            gsl = g_of_ls[lc]
            for off in (0, 1):
                rows = meta["ep_base"] + 2 * sl + off
                gp[rows] = Ng + 2 * gsl + off
                op[rows] = True
        probs.append(prob)
        metas.append(meta)
        gids_p.append(gp)
        owns_p.append(op)
        gids_l.append(gl)
        owns_l.append(ol)

    stacked = ba_mod.BAProblem(**{
        f: v if f in _POSE_FIELDS or v is None else np.stack([getattr(p, f) for p in probs])
        for f, v in probs[0]._asdict().items()})
    log.info("kf-block GBA: %d KFs, %d points + %d lines in %d chunks (%d ranks x %d)",
             len(kf_ids), Ng, len(ls_ids), n_chunks, n_blocks, C)
    return BlockedGBA(
        prob=stacked, metas=metas, kf_ids=kf_ids, block_kfs=[list(ids) for ids in blocks],
        pt_ids_glob=pt_ids, ls_ids_glob=ls_ids,
        pt_gid=np.stack(gids_p), own_pt=np.stack(owns_p),
        ls_gid=np.stack(gids_l), own_ls=np.stack(owns_l), plucker=plucker)


def make_kf_block_gba(mesh: DeviceMesh, cam: StereoCamera, cfg: ba_mod.BAConfig):
    """The chunked two-round GBA with its chunk axis over every axis of
    ``mesh``.  The returned function takes this rank's chunks (a tensor
    ``BAProblem``) and returns every rank's (T_c_w, points, lines_orth,
    lines_scale, p_active, l_active), chunks gathered in shard order; the
    same on every rank."""
    gather = functools.partial(mesh_mod.allgather, mesh=mesh)

    def run(prob: ba_mod.BAProblem):
        res = ba_mod.bundle_adjust_chunked(prob, cam, cfg, gather=gather)
        p = res.problem
        return (p.T_c_w, gather(p.points), gather(p.lines_orth), gather(p.lines_scale),
                gather(res.p_active), gather(res.l_active))

    return run


def _shard_chunks(blk: BlockedGBA, mesh: DeviceMesh, device) -> ba_mod.BAProblem:
    """This rank's run of chunks, as tensors on ``device``."""
    return ba_problem_from_numpy(blk.prob._replace(**{
        f: mesh_mod.shard_leading(v, mesh)
        for f, v in blk.prob._asdict().items() if f not in _POSE_FIELDS and v is not None}),
        device)


def write_back(mapper, blk: BlockedGBA, out) -> bool:
    """Write a GBA result over ``blk``'s chunks, ``out`` = (T_c_w, points,
    lines_orth, lines_scale, p_active, l_active) with every chunk, into the
    map: poses, points, lines and the chi^2-gated observation pruning of
    the single-device ``global_bundle_adjustment``.  A pose jump past
    ``gba_max_jump`` discards it (returns False).  Hold the map lock."""
    T_c_w, points, orth, scale, p_active, l_active = (x.cpu().numpy() for x in out)
    jump = mapper._pose_jump(blk.kf_ids, T_c_w)
    if mapper.cfg.gba_max_jump > 0 and (not np.isfinite(jump) or jump > mapper.cfg.gba_max_jump):
        log.warning("kf-block GBA discarded: max pose jump %.2f m exceeds "
                    "gba_max_jump=%.2f (solver divergence guard)", jump, mapper.cfg.gba_max_jump)
        return False
    mp = mapper.map
    for s, kfid in enumerate(blk.kf_ids):
        mp.keyframes[kfid].T_w_k = np.linalg.inv(np.asarray(T_c_w[s], np.float64))
    for c, meta in enumerate(blk.metas):
        mapper._write_back_landmarks(points[c], orth[c], scale[c], p_active[c], l_active[c],
                                     meta)
    return True


def distributed_global_bundle_adjustment(mapper, mesh: DeviceMesh) -> BlockedGBA:
    """Run the kf-block GBA on ``mesh`` and write the result into the map
    on every rank (``write_back``).  Returns the partition.

    Locking matches the single-device path: a deferred local-BA result is
    applied first, and the partition and write-back hold the map lock."""
    if mesh.device_type != mapper.device.type:
        raise ValueError(f"distributed GBA: a {mesh.device_type} mesh for a map on "
                         f"{mapper.device}")
    mapper.flush_ba()
    with mapper._map_lock:
        blk = partition_map(mapper, mesh.size())
        run = make_kf_block_gba(mesh, mapper.cam, mapper.ba_cfg)
        write_back(mapper, blk, run(_shard_chunks(blk, mesh, mapper.device)))
    return blk
