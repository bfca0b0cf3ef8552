"""Sums of rows grouped by an index, in an order fixed by the index alone.

``index_add_`` and ``scatter_add_`` on CUDA add with atomics: the order of
the float additions, and so the rounding of every sum, changes from run to
run.  Here the rows are sorted by their index (a stable sort, so the
permutation is unique), a segmented inclusive scan by doubling
(Hillis-Steele: ceil(log2 N) steps of one masked add each) leaves each
segment's total on its last sorted row, and that row is gathered into the
output.  Every addition depends only on the index, so a result repeats
bit for bit on every device.  Narrower floats are summed in float64 and
rounded once at the end: the f32 BA's line positions are sensitive to
the rounding of their normal equations (a tree of f32 adds moved them
2e-4 m against the JAX package on the ring map of
``tests/test_torch_mapping.py``; f64 sums bring them closer than the
sequential ``index_add_`` did).

A ``SegmentPlan`` holds the index's part of the work (the sort, the step
masks, the gather positions), so callers that sum several arrays over one
index, or one index over many iterations, build it once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentPlan(NamedTuple):
    order: torch.Tensor       # (N,) int64: rows in index order, stable
    same: tuple               # per step d = 2^s: (N - d,) bool, sorted rows i, i + d share an index
    last: torch.Tensor        # (n,) int64: each output's last sorted row (0 when empty)
    present: torch.Tensor     # (n,) bool: the output has a row


def segment_plan(index: torch.Tensor, n: int) -> SegmentPlan:
    """The plan of sums of rows over ``index`` (N,) ints in [0, n)."""
    keys, order = torch.sort(index, stable=True)
    N = index.shape[0]
    same, d = [], 1
    while d < N:
        same.append(keys[d:] == keys[:-d])
        d *= 2
    ids = torch.arange(n, dtype=keys.dtype, device=index.device)
    end = torch.searchsorted(keys, ids, right=True)
    start = torch.searchsorted(keys, ids)
    return SegmentPlan(order, tuple(same), torch.clamp(end - 1, min=0), end > start)


def segment_sum(values: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """(n, ...) sums of the (N, ...) rows of ``values`` over the plan's
    index; zero where no row has the output's index."""
    n = plan.last.shape[0]
    if values.shape[0] == 0:
        return values.new_zeros((n,) + values.shape[1:])
    bcast = (-1,) + (1,) * (values.dim() - 1)
    v = values[plan.order].to(torch.promote_types(values.dtype, torch.float64))
    d = 1
    for same in plan.same:
        # the right side is a new tensor, read in full before the add
        v[d:] += torch.where(same.view(bcast), v[:-d], 0.0)
        d *= 2
    return torch.where(plan.present.view(bcast), v[plan.last], 0.0).to(values.dtype)
