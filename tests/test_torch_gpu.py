"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips when no CUDA device is present.  On a
machine with one:  python -m pytest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from plslam_tpu_torch.ops import cuda_fast, cuda_hamming, cuda_patches

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def test_patch_gather_kernel(dev):
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand((3, 70, 101), generator=g).to(dev)
    y0 = torch.randint(-60, 80, (3, 41), generator=g, dtype=torch.int32).to(dev)
    x0 = torch.randint(-60, 110, (3, 41), generator=g, dtype=torch.int32).to(dev)
    n = cuda_patches.gather_patches_batch.launches
    got = cuda_patches.gather_patches_batch(imgs, y0, x0, 48)
    assert cuda_patches.gather_patches_batch.launches == n + 1
    assert torch.equal(got, cuda_patches.gather_patches_plain(imgs, y0, x0, 48))


@pytest.mark.parametrize("H,W", [(120, 188), (83, 131), (8, 8)])
def test_fast_kernel(dev, H, W):
    g = torch.Generator().manual_seed(H)
    imgs = torch.rand((2, H, W), generator=g).mul_(255).to(dev)
    thr = torch.tensor([20.0, 7.5], device=dev)
    raw, nms = cuda_fast.fast_score_nms_batch(imgs, thr)
    raw_p, nms_p = cuda_fast.fast_score_nms_plain(imgs, thr)
    assert torch.equal(raw[:, 3:-3, 3:-3], raw_p[:, 3:-3, 3:-3])
    assert torch.equal(nms[:, 4:-4, 4:-4], nms_p[:, 4:-4, 4:-4])


@pytest.mark.parametrize("n1,n2", [(1200, 1200), (37, 300), (1, 1)])
def test_hamming_kernel(dev, n1, n2):
    g = torch.Generator().manual_seed(n1)
    d1 = torch.randint(-2**31, 2**31, (n1, 8), generator=g).to(torch.int32).to(dev)
    d2 = torch.randint(-2**31, 2**31, (n2, 8), generator=g).to(torch.int32).to(dev)
    got = cuda_hamming.hamming_distance_matrix_cuda(d1, d2)
    assert torch.equal(got, cuda_hamming.hamming_plain(d1, d2))


def test_wrappers_raise_on_wrong_dtype(dev):
    with pytest.raises(TypeError):
        cuda_hamming.hamming_distance_matrix_cuda(torch.zeros((2, 8), device=dev),
                                                  torch.zeros((2, 8), device=dev))
    with pytest.raises(ValueError):
        cuda_fast.fast_score_nms_batch(torch.zeros((1, 8, 8), device=dev)[:, :, ::2],
                                       torch.zeros(1, device=dev))


def test_loop_closer_modules_on_the_card(dev):
    """The loop closer's device work on the card against the CPU: BoW
    vectors of a trained vocabulary within 1e-6, the float64 PGO within
    1e-9, and the verification match through the Hamming kernel."""
    import numpy as np

    from plslam_tpu_torch.backend import pgo, vocab
    from plslam_tpu_torch.core import lie
    from plslam_tpu_torch.ops import matching

    rng = np.random.default_rng(0)
    corpus = rng.integers(0, 2 ** 32, (600, 8), dtype=np.uint32).view(np.int32)
    voc = vocab.train_vocabulary(corpus, k=6, depth=2, iters=2)
    desc = torch.from_numpy(corpus[:150].copy())
    valid = torch.from_numpy(rng.uniform(size=150) < 0.8)
    want = vocab.transform(voc, desc, valid)
    got = vocab.transform(voc.to(dev), desc.to(dev), valid.to(dev)).cpu()
    assert torch.allclose(got, want, rtol=0, atol=1e-6)

    K = 13
    xi = torch.from_numpy(rng.normal(0, 0.05, (K - 1, 6)))
    steps = lie.exp_se3(xi)
    T = [torch.eye(4, dtype=torch.float64)]
    for S in steps:
        T.append(T[-1] @ S)
    ei = torch.cat([torch.arange(K - 1), torch.tensor([K - 1])])
    ej = torch.cat([torch.arange(1, K), torch.tensor([0])])
    g = pgo.PoseGraph(T_w_k=torch.stack(T), fixed=torch.arange(K) == 0,
                      valid=torch.ones(K, dtype=torch.bool), e_i=ei, e_j=ej,
                      e_T=torch.cat([steps, torch.eye(4, dtype=torch.float64)[None]]),
                      e_info=torch.ones(K, dtype=torch.float64),
                      e_valid=torch.ones(K, dtype=torch.bool))
    want = pgo.optimize(g, 10).T_w_k
    got = pgo.optimize(pgo.PoseGraph(*(x.to(dev) for x in g)), 10).T_w_k.cpu()
    assert torch.allclose(got, want, rtol=0, atol=1e-9)

    d = torch.from_numpy(corpus[:160].copy())
    mask = torch.ones((160, 160), dtype=torch.bool)
    n = cuda_hamming.hamming_distance_matrix_cuda.launches
    got = matching.match_descriptors(d.to(dev), d.to(dev), mask.to(dev), 0.9).idx.cpu()
    assert cuda_hamming.hamming_distance_matrix_cuda.launches == n + 1
    assert torch.equal(got, matching.match_descriptors(d, d, mask, 0.9).idx)
