"""Binary bag-of-words place recognition (``plslam_tpu.backend.vocab``;
reference ``3rdparty/DBoW2`` TemplatedVocabulary transform/score over
256-bit descriptors and the conf_matrix rows of mapHandler.cpp
insertKFBowVector* :4118-4239).

The vocabulary is a fixed (branching k, depth d) tree stored as one
descriptor array per level; ``transform`` descends it for all N
descriptors at once (a Hamming argmin over the k children per level) and
returns a dense L1-normalized (k^d,) tf or tf-idf vector.  Training is host
numpy k-means with the JAX package's random draws, so both packages train
the same levels.  Levels are (k^(l+1), 8) int32 words, LSB-first.
"""

from __future__ import annotations

import gzip
import re
from typing import NamedTuple

import numpy as np
import torch

from ..ops.descriptors import popcount32


class Vocabulary(NamedTuple):
    """Hierarchical binary vocabulary; level l holds k^(l+1) node
    descriptors (children of level l-1 nodes, contiguous blocks of k)."""

    levels: tuple[torch.Tensor, ...]  # each (k^(l+1), 8) int32
    k: int
    depth: int
    word_weight: torch.Tensor | None = None  # (k^depth,) idf weights; None = tf

    @property
    def num_words(self) -> int:
        return self.k ** self.depth

    def to(self, device) -> "Vocabulary":
        return self._replace(
            levels=tuple(lv.to(device) for lv in self.levels),
            word_weight=None if self.word_weight is None else self.word_weight.to(device))


def _pack_np(bits: np.ndarray) -> np.ndarray:
    """(..., 256) {0,1} -> (..., 8) int32 words, LSB-first."""
    b = np.asarray(bits, np.uint8).reshape(bits.shape[:-1] + (8, 32))
    w = (b.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return w.astype(np.uint32).view(np.int32)


def _unpack_np(words: np.ndarray) -> np.ndarray:
    """(..., 8) int32 or uint32 words -> (..., 256) uint8 bits."""
    w = np.ascontiguousarray(words).view(np.uint32)
    return np.unpackbits(w.view(np.uint8), axis=-1, bitorder="little")


def _majority_centroid(bits: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Binary k-means centroid: per-bit weighted majority."""
    w = weights[:, None]
    frac = (bits * w).sum(0) / max(w.sum(), 1e-9)
    return (frac >= 0.5).astype(np.int8)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 3,
                     iters: int = 8, seed: int = 0) -> Vocabulary:
    """Host hierarchical binary k-means; the same ``default_rng`` draws in
    the same order as the JAX package, so the levels are identical."""
    rng = np.random.default_rng(seed)
    bits = _unpack_np(descriptors)

    def kmeans(sub: np.ndarray) -> np.ndarray:
        n = len(sub)
        if n == 0:
            return np.zeros((k, 256), np.int8)
        init = sub[rng.choice(n, size=min(k, n), replace=False)]
        cents = np.zeros((k, 256), np.int8)
        cents[: len(init)] = init
        if len(init) < k:  # duplicate-pad
            cents[len(init):] = init[rng.integers(0, len(init), k - len(init))]
        for _ in range(iters):
            assign = (sub[:, None, :] != cents[None, :, :]).sum(-1).argmin(1)
            for c in range(k):
                sel = sub[assign == c]
                if len(sel):
                    cents[c] = _majority_centroid(sel, np.ones(len(sel)))
        return cents

    levels = []
    parents = [bits]
    for l in range(depth):
        cents_l, next_parents = [], []
        for sub in parents:
            cents = kmeans(sub)
            cents_l.append(cents)
            if l + 1 < depth:
                assign = ((sub[:, None, :] != cents[None, :, :]).sum(-1).argmin(1)
                          if len(sub) else np.zeros(0, np.int64))
                next_parents += [sub[assign == c] if len(sub) else sub for c in range(k)]
        levels.append(torch.from_numpy(_pack_np(np.concatenate(cents_l, axis=0))))
        parents = next_parents
    return Vocabulary(levels=tuple(levels), k=k, depth=depth)


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descriptors (N, 8) int32 -> dense L1-normalized BoW vector (k^depth,)
    f32: at each level, gather each descriptor's k children and take the
    Hamming argmin (first index on ties)."""
    n, k = desc.shape[0], voc.k
    node = torch.zeros(n, dtype=torch.int64, device=desc.device)
    ar = torch.arange(k, device=desc.device)
    for l in range(voc.depth):
        cand = voc.levels[l][node[:, None] * k + ar[None, :]]      # (N, k, 8)
        d = popcount32(desc[:, None, :] ^ cand).sum(-1)            # (N, k)
        node = node * k + torch.argmin(d, dim=-1)
    counts = torch.zeros(voc.num_words, dtype=torch.float32, device=desc.device)
    counts = counts.index_add_(0, node, valid.to(torch.float32))
    if voc.word_weight is not None:
        counts = counts * voc.word_weight
    return counts / torch.clamp(counts.sum(), min=1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score in [0, 1] of L1-normalized vectors
    (ScoringObject.cpp L1Scoring); broadcasts over leading axes."""
    return 1.0 - 0.5 * torch.sum(torch.abs(v1 - v2), dim=-1)


def score_against_database(v: torch.Tensor, db: torch.Tensor,
                           db_valid: torch.Tensor) -> torch.Tensor:
    """One BoW vector against a (D, W) database -> (D,) scores; invalid
    rows get -1."""
    return torch.where(db_valid, l1_score(v[None, :], db), -1.0)


# ---------------------------------------------------------------------------
# DBoW2 vocabulary files (TemplatedVocabulary::save OpenCV-YAML layout,
# TemplatedVocabulary.h:1341-1431).  Non-uniform trees are lowered to full
# depth by chaining a shallow leaf to itself; missing child slots are
# padded with a duplicate sibling after the real ones, so argmin ties
# resolve to the real child.
# ---------------------------------------------------------------------------


def _open_vocab(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


_NODE_RE = re.compile(
    r"nodeId:\s*(\d+),\s*parentId:\s*(\d+),\s*weight:"
    r"\s*([0-9.eE+-]+),\s*descriptor:\s*\"?([0-9 ]+)")


def load_dbow2_vocabulary(path: str) -> Vocabulary:
    """Parse a DBoW2 OpenCV-YAML vocabulary (.yml / .yml.gz) into levels."""
    k = depth = None
    nodes = {}        # id -> (parent, weight, desc_bytes)
    children = {0: []}
    with _open_vocab(path, "r") as f:
        for line in f:
            mk = re.match(r"^\s*k:\s*(\d+)\s*$", line)
            if k is None and mk:
                k = int(mk.group(1))
                continue
            ml = re.match(r"^\s*L:\s*(\d+)\s*$", line)
            if depth is None and ml:
                depth = int(ml.group(1))
                continue
            m = _NODE_RE.search(line)
            if m:
                nid, pid = int(m.group(1)), int(m.group(2))
                dbytes = np.asarray([int(x) for x in m.group(4).split()], np.uint8)
                nodes[nid] = (pid, float(m.group(3)), dbytes)
                children.setdefault(pid, []).append(nid)
                children.setdefault(nid, [])
    if k is None or depth is None or not nodes:
        raise ValueError(f"not a DBoW2 vocabulary file: {path}")

    def packed(dbytes: np.ndarray) -> np.ndarray:
        return _pack_np(np.unpackbits(dbytes, bitorder="little")[:256])

    levels = [np.zeros((k ** (l + 1), 8), np.int32) for l in range(depth)]
    weights = np.zeros(k ** depth, np.float32)
    frontier = [(0, 0)]  # (node id, position in its level)
    for l in range(depth):
        nxt = []
        for nid, pos in frontier:
            ch = children.get(nid, [])
            if not ch and nid != 0:
                ch = [nid]  # lower a shallow leaf by self-chaining
            ch = ch[:k]
            pad = ch + [ch[-1]] * (k - len(ch)) if ch else [nid] * k
            n_real = max(len(ch), 1)
            for j, cid in enumerate(pad):
                _, w, dbytes = nodes.get(cid, nodes.get(nid))
                levels[l][pos * k + j] = packed(dbytes)
                if j < n_real:
                    if l == depth - 1:
                        weights[pos * k + j] = w
                    nxt.append((cid, pos * k + j))
        frontier = nxt
    word_weight = torch.from_numpy(weights) if weights.max() > 0 else None
    return Vocabulary(levels=tuple(torch.from_numpy(lv) for lv in levels), k=k,
                      depth=depth, word_weight=word_weight)


def save_dbow2_vocabulary(path: str, voc: Vocabulary, name: str = "vocabulary") -> None:
    """Write the vocabulary in DBoW2's OpenCV-YAML text layout."""
    k, depth = voc.k, voc.depth
    ww = (voc.word_weight.cpu().numpy() if voc.word_weight is not None
          else np.ones(voc.num_words, np.float32))
    lines = ["%YAML:1.0", "---", f"{name}:", f"   k: {k}", f"   L: {depth}",
             "   scoringType: 0", "   weightingType: 0", "   nodes:"]
    next_id = 1
    ids = []  # per level: position -> nodeId
    for l in range(depth):
        lv = voc.levels[l].cpu().numpy()
        n = lv.shape[0]
        lvl_ids = np.arange(next_id, next_id + n)
        next_id += n
        ids.append(lvl_ids)
        dbytes = np.packbits(_unpack_np(lv), axis=-1, bitorder="little")
        for p in range(n):
            pid = 0 if l == 0 else int(ids[l - 1][p // k])
            w = float(ww[p]) if l == depth - 1 else 0.0
            dstr = " ".join(str(int(b)) for b in dbytes[p])
            lines.append(f"      - {{ nodeId:{int(lvl_ids[p])}, parentId:{pid}, "
                         f"weight:{w:.6g}, descriptor:\"{dstr}\" }}")
    lines.append("   words:")
    for wpos in range(voc.num_words):
        lines.append(f"      - {{ wordId:{wpos}, nodeId:{int(ids[-1][wpos])} }}")
    with _open_vocab(path, "w") as f:
        f.write("\n".join(lines) + "\n")
