"""The fixed-order sums that replaced the port's float atomics
(``core/segment.py``, the line merge of ``ops/lines.py``, the BA and PGO
normal equations) against the ``index_add_`` / ``scatter_add_`` sums they
replaced, on the CPU (where those add in index order): to 1e-6 relative in
float32, to 1e-12 in float64; and each result repeats bit for bit."""

import numpy as np
import pytest
import torch

from plslam_tpu_torch.backend import ba, pgo
from plslam_tpu_torch.convert import ba_problem_from_numpy
from plslam_tpu_torch.core.camera import StereoCamera
from plslam_tpu_torch.core.segment import segment_plan, segment_sum
from plslam_tpu_torch.ops import lines

from test_torch_helpers import one_torch_thread  # noqa: F401


def _index_add(values, index, n):
    return values.new_zeros((n,) + values.shape[1:]).index_add_(0, index, values)


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("N,n,tail", [(0, 4, ()), (1, 1, ()), (2, 10, (3,)), (7, 3, (2, 2)),
                                      (1000, 37, (6, 6)), (5000, 2000, (4,)),
                                      (8192, 8, (42,))])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
def test_segment_sum_equals_index_add(N, n, tail, dtype, tol):
    g = torch.Generator().manual_seed(N * 31 + n)
    index = torch.randint(0, n, (N,), generator=g)
    values = torch.randn((N,) + tail, generator=g, dtype=torch.float64).to(dtype)
    plan = segment_plan(index, n)
    got = segment_sum(values, plan)
    assert got.shape == (n,) + tail and got.dtype == dtype
    want = _index_add(values.double(), index, n)
    if N:
        assert _rel(got, want) <= tol
        # the float32 index_add_ it replaced, within the same bound
        assert _rel(_index_add(values, index, n), want) <= 10 * tol
    assert torch.equal(segment_sum(values, plan), got)
    untouched = torch.ones(n, dtype=torch.bool)
    untouched[index] = False
    assert not got[untouched].any()


def test_line_merge_sums_equal_scatter_add():
    """Three collinear chains of touching cell segments: each merged line's
    score, the component's mass sum, is the scatter_add_ sum over its
    chain."""
    xs, ys, masses = [], [], []
    rng = np.random.default_rng(4)
    for row, n in ((20.0, 5), (60.0, 7), (100.0, 4)):
        xs.append(np.arange(n, dtype=np.float32) * 10.0)
        ys.append(np.full(n, row, np.float32))
        masses.append(rng.uniform(1.0, 9.0, n).astype(np.float32))
    x, y, mass = np.concatenate(xs), np.concatenate(ys), np.concatenate(masses)
    sp = torch.from_numpy(np.stack([x, y], -1))[None]
    ep = sp + torch.tensor([10.0, 0.0])
    d = torch.tensor([[1.0, 0.0]]).expand(1, len(x), 2)
    m = torch.from_numpy(mass)[None]
    valid = torch.ones_like(m, dtype=torch.bool)
    out = lines._merge_components(sp, ep, d, m, valid, lines.LineDetectorConfig(max_out=4))
    chain = torch.from_numpy(np.repeat(np.arange(3), [5, 7, 4]))[None]
    want = torch.zeros((1, 3)).scatter_add_(1, chain, m)[0]
    got = out.score[0][out.valid[0]]
    assert torch.allclose(torch.sort(got).values, torch.sort(want).values, rtol=1e-6, atol=0)
    assert torch.equal(out.score, lines._merge_components(
        sp, ep, d, m, valid, lines.LineDetectorConfig(max_out=4)).score)


def _ba_problem(dtype, K=5, P=60, L=12, seed=2):
    """Every camera sees every landmark; a few observations invalid."""
    rng = np.random.default_rng(seed)
    cp, lp = np.repeat(np.arange(K), P), np.tile(np.arange(P), K)
    cl, ll = np.repeat(np.arange(K), L), np.tile(np.arange(L), K)
    T = np.tile(np.eye(4), (K, 1, 1))
    T[:, :3, 3] = rng.uniform(-0.3, 0.3, (K, 3))
    A = rng.uniform(-1, 1, (L, 3)) + [0, 0, 6]
    Bp = A + rng.uniform(-1, 1, (L, 3))
    nrm = np.cross(A, Bp)
    dirs = Bp - A
    Lw = np.concatenate([nrm, dirs], -1) / np.linalg.norm(dirs, axis=-1, keepdims=True)
    from plslam_tpu_torch.core.plucker import plucker_to_orth
    orth = plucker_to_orth(torch.from_numpy(Lw)).numpy()
    prob = dict(T_c_w=T, pose_fixed=np.arange(K) == 0, pose_valid=np.ones(K, bool),
                points=rng.uniform(-2, 2, (P, 3)) + [0, 0, 6], point_valid=np.ones(P, bool),
                lines_orth=orth, lines_scale=np.ones(L), line_valid=np.ones(L, bool),
                p_cam=cp, p_lm=lp, p_uv=rng.uniform(100, 600, (K * P, 2)),
                p_sigma2=np.ones(K * P), p_valid=rng.uniform(size=K * P) < 0.9,
                l_cam=cl, l_lm=ll, l_sobs=rng.uniform(100, 600, (K * L, 2)),
                l_eobs=rng.uniform(100, 600, (K * L, 2)), l_sigma2=np.ones(K * L),
                l_valid=rng.uniform(size=K * L) < 0.9)
    prob = {k: (v.astype(np.float64 if dtype == torch.float64 else np.float32)
                if v.dtype.kind == "f" else v) for k, v in prob.items()}
    return ba_problem_from_numpy(prob, "cpu")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
def test_ba_assembly_equals_index_add(dtype, tol, monkeypatch):
    cam = StereoCamera.create(435.25, 435.25, 367.5, 252.25, 0.110074)
    prob = _ba_problem(dtype)
    got = ba.assemble(prob, cam, ba.BAConfig(), prob.p_valid, prob.l_valid)
    again = ba.assemble(prob, cam, ba.BAConfig(), prob.p_valid, prob.l_valid)
    # the index_add_ assembly it replaced, summed in float64
    monkeypatch.setattr(ba, "segment_plan", lambda idx, n: (idx, n))
    monkeypatch.setattr(ba, "segment_sum",
                        lambda v, plan: _index_add(v.double(), *plan).to(v.dtype))
    want = ba.assemble(prob, cam, ba.BAConfig(), prob.p_valid, prob.l_valid)
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == dtype and _rel(g, w) <= tol, name
        assert torch.equal(g, getattr(again, name)), name


def test_pgo_system_equals_index_add():
    g = torch.Generator().manual_seed(5)
    K, E = 9, 20
    xi = torch.randn((K, 6), generator=g, dtype=torch.float64) * 0.2
    from plslam_tpu_torch.core import lie
    T = lie.exp_se3(xi)
    e_i = torch.randint(0, K, (E,), generator=g)
    e_j = (e_i + torch.randint(1, K, (E,), generator=g)) % K
    Z = lie.exp_se3(torch.randn((E, 6), generator=g, dtype=torch.float64) * 0.1)
    graph = pgo.PoseGraph(T_w_k=T, fixed=torch.arange(K) == 0,
                          valid=torch.ones(K, dtype=torch.bool), e_i=e_i, e_j=e_j, e_T=Z,
                          e_info=torch.rand(E, generator=g, dtype=torch.float64) + 0.5,
                          e_valid=torch.rand(E, generator=g) < 0.9)
    H, b, cost = pgo.build_system(graph)
    e, Ji, Jj = pgo.edge_res_and_jac(T[e_i], T[e_j], Z)
    w = torch.where(graph.e_valid, graph.e_info, 0.0)[:, None, None]
    rows, cols = torch.cat([e_i, e_j, e_i, e_j]), torch.cat([e_i, e_j, e_j, e_i])
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    H_ref = _index_add(torch.cat([w * JiT @ Ji, w * JjT @ Jj, w * JiT @ Jj, w * JjT @ Ji]),
                       rows * K + cols, K * K).view(K, K, 6, 6)
    b_ref = _index_add(torch.cat([(w * JiT @ e[..., None])[..., 0],
                                  (w * JjT @ e[..., None])[..., 0]]),
                       torch.cat([e_i, e_j]), K)
    assert _rel(H, H_ref) <= 1e-12 and _rel(b, b_ref) <= 1e-12
    assert torch.equal(H, pgo.build_system(graph, pgo.system_plans(graph))[0])
