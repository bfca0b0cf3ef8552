"""Map checkpoint / resume (``plslam_tpu.io.checkpoint``).

The whole map (keyframe poses and host features, landmark tables, flat
observation tables, covisibility) and the loop closer's state (vocabulary
levels, per-keyframe BoW records, conf matrix) go to one compressed npz
with the JAX package's keys and layout.  Descriptor words are uint32 in the
file and int32 in the port (a bit view), so a map saved by either package
loads into the other: this is how the port takes over the JAX package's
state.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..backend.mapping import KeyframeRecord, MapHandler, _ObsTable
from ..backend.vocab import Vocabulary

_KF_FIELDS = [
    "pt_uv", "pt_P", "pt_desc", "pt_sigma2", "pt_valid", "pt_lm",
    "ls_sp", "ls_ep", "ls_sP", "ls_eP", "ls_NDc", "ls_desc", "ls_sigma2",
    "ls_valid", "ls_lm",
]


def _u32(a: np.ndarray) -> np.ndarray:
    """int32 words -> their uint32 bit patterns (the file's dtype)."""
    return np.ascontiguousarray(a).view(np.uint32)


def _i32(a: np.ndarray) -> np.ndarray:
    """Descriptor words from a file (uint32, or int32) -> int32 view."""
    a = np.array(a, copy=True)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def _obs_triples(table: _ObsTable) -> np.ndarray:
    """Live (lm, kf, feat) rows in insertion order."""
    live = np.where(table.valid[: table.n])[0]
    return np.stack([table.lm[live], table.kf[live], table.fi[live]], axis=1) \
        if len(live) else np.zeros((0, 3), np.int64)


def _restore_obs(triples: np.ndarray, n_lm: int):
    """A flat obs table and per-landmark observation counts."""
    table = _ObsTable(max(1024, len(triples)))
    n = len(triples)
    if n:
        table.lm[:n], table.kf[:n], table.fi[:n] = triples[:, 0], triples[:, 1], triples[:, 2]
        table.valid[:n] = True
    table.n = n
    nobs = np.bincount(triples[:, 0], minlength=n_lm).astype(np.int64) if n \
        else np.zeros(n_lm, np.int64)
    return table, nobs


def _lc_state(lc) -> dict:
    data: dict = {}
    if lc is None or lc.voc is None:
        return data
    data["lc_conf"] = lc.conf
    data["lc_closed_at"] = np.asarray(lc.closed_at)
    for name, voc in (("p", lc.voc), ("l", lc.voc_l)):
        if voc is None:
            continue
        data[f"lc_voc_{name}_meta"] = np.asarray([voc.k, voc.depth])
        for i, lvl in enumerate(voc.levels):
            data[f"lc_voc_{name}_level{i}"] = _u32(lvl.cpu().numpy())
        if voc.word_weight is not None:
            data[f"lc_voc_{name}_ww"] = voc.word_weight.cpu().numpy()
    if lc.bow:
        data["lc_bow_p"] = np.stack([b["p"] for b in lc.bow])
        data["lc_bow_meta"] = np.asarray(
            [[b["n_pt"], b["std_pt"], b["n_ls"], b["std_ls"]] for b in lc.bow], np.float64)
        if all(b["l"] is not None for b in lc.bow):
            data["lc_bow_l"] = np.stack([b["l"] for b in lc.bow])
    return data


def _restore_lc(z: Mapping, lc) -> None:
    if lc is None or "lc_conf" not in z:
        return
    lc.conf = np.array(z["lc_conf"])
    lc.closed_at = int(z["lc_closed_at"])
    for name in ("p", "l"):
        if f"lc_voc_{name}_meta" not in z:
            continue
        k, depth = (int(x) for x in z[f"lc_voc_{name}_meta"])
        voc = Vocabulary(
            levels=tuple(torch.from_numpy(_i32(z[f"lc_voc_{name}_level{i}"]))
                         for i in range(depth)),
            k=k, depth=depth,
            word_weight=(torch.from_numpy(np.array(z[f"lc_voc_{name}_ww"], np.float32))
                         if f"lc_voc_{name}_ww" in z else None)).to(lc.device)
        setattr(lc, "voc" if name == "p" else "voc_l", voc)
    lc.bow = []
    if "lc_bow_p" in z:
        P, meta = z["lc_bow_p"], z["lc_bow_meta"]
        L = z["lc_bow_l"] if "lc_bow_l" in z else None
        for i in range(len(P)):
            lc.bow.append({"p": P[i], "l": None if L is None else L[i],
                           "n_pt": int(meta[i, 0]), "std_pt": float(meta[i, 1]),
                           "n_ls": int(meta[i, 2]), "std_ls": float(meta[i, 3])})


def map_state(mapper: MapHandler, loop_closer=None) -> dict:
    """The map (and loop-closer) state as the checkpoint's dict of numpy
    arrays, descriptor words as uint32."""
    mp = mapper.map
    data = {
        "covis": mp.covis,
        "pt_w": mp.pt_w, "pt_desc": _u32(mp.pt_desc), "pt_valid": mp.pt_valid,
        "pt_first_kf": mp.pt_first_kf, "pt_last_kf": mp.pt_last_kf,
        "ls_w": mp.ls_w, "ls_epw": mp.ls_epw, "ls_desc": _u32(mp.ls_desc),
        "ls_valid": mp.ls_valid, "ls_first_kf": mp.ls_first_kf,
        "ls_last_kf": mp.ls_last_kf,
        "n_kf": np.asarray(len(mp.keyframes)),
        "pt_obs": _obs_triples(mp.pobs), "ls_obs": _obs_triples(mp.lobs),
    }
    for i, kf in enumerate(mp.keyframes):
        data[f"kf{i}_pose"] = kf.T_w_k
        data[f"kf{i}_active"] = np.asarray(kf.active)
        for f in _KF_FIELDS:
            v = getattr(kf, f)
            data[f"kf{i}_{f}"] = _u32(v) if f.endswith("_desc") else v
    data.update(_lc_state(loop_closer))
    return data


def restore_map_state(z: Mapping, mapper: MapHandler, loop_closer=None) -> MapHandler:
    """Restore a checkpoint dict (an npz file or a dict of numpy arrays in
    the JAX package's layout) into ``mapper`` and ``loop_closer`` in place."""
    mp = mapper.map
    K = int(z["n_kf"])
    cap = 16
    while cap < K:
        cap *= 2
    # covis goes straight into the capacity buffer: the (K, K) view is
    # sized by len(keyframes), rebuilt below
    mp._covis_buf = np.zeros((cap, cap), np.int32)
    mp._covis_buf[:K, :K] = z["covis"]
    mp.n_pt = len(z["pt_valid"])
    mp._pt_w = np.array(z["pt_w"], np.float64)
    mp._pt_desc = _i32(z["pt_desc"])
    mp._pt_valid = np.array(z["pt_valid"])
    mp._pt_first_kf = np.array(z["pt_first_kf"], np.int64)
    mp._pt_last_kf = np.array(z["pt_last_kf"], np.int64)
    mp.n_ls = len(z["ls_valid"])
    mp._ls_w = np.array(z["ls_w"], np.float64)
    mp._ls_epw = (np.array(z["ls_epw"], np.float64) if "ls_epw" in z
                  else np.zeros((mp.n_ls, 2, 3)))
    mp._ls_desc = _i32(z["ls_desc"])
    mp._ls_valid = np.array(z["ls_valid"])
    mp._ls_first_kf = np.array(z["ls_first_kf"], np.int64)
    mp._ls_last_kf = np.array(z["ls_last_kf"], np.int64)
    mp.pobs, mp._pt_nobs = _restore_obs(np.asarray(z["pt_obs"], np.int64), mp.n_pt)
    mp.lobs, mp._ls_nobs = _restore_obs(np.asarray(z["ls_obs"], np.int64), mp.n_ls)
    mp.keyframes = []
    for i in range(K):
        kf = KeyframeRecord.__new__(KeyframeRecord)
        kf.id = i
        kf.T_w_k = np.array(z[f"kf{i}_pose"], np.float64)
        kf.active = bool(z[f"kf{i}_active"]) if f"kf{i}_active" in z else True
        for f in _KF_FIELDS:
            setattr(kf, f, _i32(z[f"kf{i}_{f}"]) if f.endswith("_desc")
                    else np.array(z[f"kf{i}_{f}"]))
        kf.dev, kf.device = None, mapper.device
        mp.keyframes.append(kf)
    _restore_lc(z, loop_closer)
    return mapper


def save_map(path: str, mapper: MapHandler, loop_closer=None) -> None:
    np.savez_compressed(path, **map_state(mapper, loop_closer))


def load_map(path: str, mapper: MapHandler, loop_closer=None) -> MapHandler:
    """Restore a saved map in place (the mapper supplies camera and configs)."""
    with np.load(path, allow_pickle=False) as z:
        return restore_map_state({k: z[k] for k in z.files}, mapper, loop_closer)
