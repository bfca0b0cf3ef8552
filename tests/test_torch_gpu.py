"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``; each test skips when no CUDA device is present.  On a
machine with one (``--noconftest``: its tests/conftest.py imports jax):
    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
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


@pytest.mark.parametrize("B,H,W,N", [(2, 480, 752, 1200), (4, 480, 752, 1536),
                                     (3, 376, 1241, 300), (1, 70, 101, 41)])
def test_patch_gather_kernel(dev, B, H, W, N):
    """ORB and LBD shapes, a KITTI-wide stack and B = 1; corners up to P px
    outside every edge."""
    P = 48
    g = torch.Generator().manual_seed(N)
    imgs = torch.rand((B, H, W), generator=g).to(dev)
    y0 = torch.randint(-2 * P, H + P, (B, N), generator=g, dtype=torch.int32).to(dev)
    x0 = torch.randint(-2 * P, W + P, (B, N), generator=g, dtype=torch.int32).to(dev)
    n = cuda_patches.gather_patches_batch.launches
    got = cuda_patches.gather_patches_batch(imgs, y0, x0, P)
    assert cuda_patches.gather_patches_batch.launches == n + 1
    assert torch.equal(got, cuda_patches.gather_patches_plain(imgs, y0, x0, P))


@pytest.mark.parametrize("B,H,W", [(2, 480, 752), (2, 400, 627), (2, 333, 522), (2, 278, 435),
                                   (2, 376, 1241), (1, 120, 188), (2, 83, 131), (1, 8, 8),
                                   (1, 17, 33)])
@pytest.mark.parametrize("kind", ["noise", "blobs", "flat"])
def test_fast_kernel(dev, B, H, W, kind):
    """The VO pyramid's four levels, a KITTI-wide pair, B = 1 and tiles cut
    by the image edge; dense corners (noise), sparse corners on a flat
    background (blobs) and no corners (flat)."""
    g = torch.Generator().manual_seed(H * W)
    if kind == "noise":
        imgs = torch.rand((B, H, W), generator=g).mul_(255)
    else:
        imgs = torch.full((B, H, W), 30.0)
        if kind == "blobs":
            mask = torch.rand((B, H, W), generator=g) < 0.02
            imgs = torch.where(mask, torch.rand((B, H, W), generator=g) * 200 + 50, imgs)
    imgs = imgs.to(dev)
    thr = torch.tensor([20.0, 7.5][:B], device=dev)
    n = cuda_fast.fast_score_nms_batch.launches
    raw, nms = cuda_fast.fast_score_nms_batch(imgs, thr)
    assert cuda_fast.fast_score_nms_batch.launches == n + 1
    raw_p, nms_p = cuda_fast.fast_score_nms_plain(imgs, thr)
    assert torch.equal(raw[:, 3:-3, 3:-3], raw_p[:, 3:-3, 3:-3])
    assert torch.equal(nms[:, 4:-4, 4:-4], nms_p[:, 4:-4, 4:-4])


@pytest.mark.parametrize("n1,n2", [(1200, 1200), (2048, 1200), (256, 256), (160, 160),
                                   (24, 24), (37, 300), (1, 1), (0, 5), (5, 0)])
def test_hamming_kernel(dev, n1, n2):
    g = torch.Generator().manual_seed(n1 * 7 + n2)
    d1 = torch.randint(-2**31, 2**31, (n1, 8), generator=g).to(torch.int32)
    d2 = torch.randint(-2**31, 2**31, (n2, 8), generator=g).to(torch.int32)
    # all-ones and all-zeros words in a few rows
    d1[:n1 // 3] = -1
    d2[n2 // 2:n2 // 2 + 3] = 0
    d1, d2 = d1.to(dev), d2.to(dev)
    got = cuda_hamming.hamming_distance_matrix_cuda(d1, d2)
    assert got.shape == (n1, n2) and got.dtype == torch.int32
    assert torch.equal(got, cuda_hamming.hamming_plain(d1, d2))


@pytest.mark.parametrize("word", [-1, 0])
def test_hamming_kernel_constant_words(dev, word):
    """All-ones against all-zeros words: every distance 0 or 256."""
    d1 = torch.full((70, 8), word, dtype=torch.int32, device=dev)
    d2 = torch.cat([torch.full((3, 8), -1, dtype=torch.int32),
                    torch.zeros((66, 8), dtype=torch.int32)]).to(dev)
    got = cuda_hamming.hamming_distance_matrix_cuda(d1, d2)
    assert torch.equal(got, cuda_hamming.hamming_plain(d1, d2))
    assert set(got.unique().tolist()) == {0, 256}


@pytest.mark.parametrize("n1,n2", [(1200, 1200), (37, 300), (1, 1)])
def test_hamming_probe_variants(dev, n1, n2):
    """The probe's inner products (python -m plslam_tpu_torch.hamming_probe)
    are the Hamming matrix too."""
    from plslam_tpu_torch import hamming_probe

    lib = hamming_probe.build()
    g = torch.Generator().manual_seed(n1 + n2)
    d1 = torch.randint(-2**31, 2**31, (n1, 8), generator=g).to(torch.int32).to(dev)
    d2 = torch.randint(-2**31, 2**31, (n2, 8), generator=g).to(torch.int32).to(dev)
    want = cuda_hamming.hamming_plain(d1, d2)
    for name in ["shipped", *hamming_probe.VARIANTS]:
        out = torch.full((n1, n2), -1, dtype=torch.int32, device=dev)
        hamming_probe.launcher(lib, name)(d1, d2, out)
        assert torch.equal(out, want), name


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


def test_remap_on_the_card(dev, tmp_path):
    """The disk path's rectification (ops/image.remap, plain torch) on the
    card against the same call on the CPU: configs/euroc_params.yaml's maps
    on a 752x480 pair, within 1e-3 grey levels; and the loader's uint8
    upload and remap end to end."""
    import os

    import cv2
    import numpy as np

    from plslam_tpu_torch.io import euroc
    from plslam_tpu_torch.io.loader import StereoLoader
    from plslam_tpu_torch.ops.image import remap

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    calib = euroc.load_euroc_calib(os.path.join(root, "configs", "euroc_params.yaml"))
    g = torch.Generator().manual_seed(0)
    imgs = torch.rand((2, 480, 752), generator=g).mul_(255).round_()
    mx = torch.from_numpy(np.stack([calib.map_l[0], calib.map_r[0]]))
    my = torch.from_numpy(np.stack([calib.map_l[1], calib.map_r[1]]))
    want = remap(imgs, mx, my)
    got = remap(imgs.to(dev), mx.to(dev), my.to(dev))
    assert got.device.type == "cuda"
    assert (got.cpu() - want).abs().max().item() <= 1e-3
    files = [str(tmp_path / f"{s}.png") for s in ("l", "r")]
    for f, img in zip(files, imgs):
        assert cv2.imwrite(f, img.to(torch.uint8).numpy())
    with StereoLoader(files[:1], files[1:], 752, 480, maps=(calib.map_l, calib.map_r),
                      device=dev) as nl:
        il, ir = nl.get(0)
    assert il.device == dev and il.dtype == torch.float32
    assert (torch.stack([il, ir]).cpu() - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("B,n1,n2", [(1, 1200, 1200), (3, 37, 300), (3, 256, 255),
                                     (16, 1200, 1200), (16, 100, 7), (16, 1, 64)])
def test_batched_hamming_kernel(dev, B, n1, n2):
    """B matrices in one launch against the plain twin of each stream;
    also an operand at batch stride 0 (shared by every stream) and one at
    a wider stride (every other stream of a stack)."""
    g = torch.Generator().manual_seed(B * 1000 + n1 + n2)
    d1 = torch.randint(-2**31, 2**31, (B, n1, 8), generator=g).to(torch.int32).to(dev)
    d2 = torch.randint(-2**31, 2**31, (2 * B, n2, 8), generator=g).to(torch.int32).to(dev)
    d1[:, : n1 // 3] = -1
    wide = d2[::2]
    n = cuda_hamming.hamming_distance_matrix_cuda.launches
    got = cuda_hamming.hamming_distance_matrix_cuda(d1, wide)
    assert cuda_hamming.hamming_distance_matrix_cuda.launches == n + 1
    assert got.shape == (B, n1, n2)
    assert torch.equal(got, cuda_hamming.hamming_plain(d1, wide))
    shared = d2[0].expand(B, n2, 8)
    assert torch.equal(cuda_hamming.hamming_distance_matrix_cuda(d1, shared),
                       cuda_hamming.hamming_plain(d1, shared))
    # the operator's vmap rule: one launch for the vmapped 2-D call
    n = cuda_hamming.hamming_distance_matrix_cuda.launches
    got = torch.func.vmap(cuda_hamming.hamming_distance_matrix)(d1, wide.contiguous())
    assert cuda_hamming.hamming_distance_matrix_cuda.launches == n + 1
    assert torch.equal(got, cuda_hamming.hamming_plain(d1, wide))


def test_batched_vo_launches_per_frame(dev):
    """A batched frame launches each kernel as often as a one-stream frame:
    4 FAST, 2 patch gathers, 4 Hamming, at B = 1 and B = 3."""
    import numpy as np

    from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.frontend.frame import FrontendConfig
    from plslam_tpu_torch.io import SyntheticScene, circular_trajectory

    poses = circular_trajectory(3)
    wrappers = (cuda_fast.fast_score_nms_batch, cuda_patches.gather_patches_batch,
                cuda_hamming.hamming_distance_matrix_cuda)
    for B in (1, 3):
        scenes = [SyntheticScene(seed=s) for s in range(B)]
        fr = [[torch.from_numpy(np.stack(x)).to(dev) for x in zip(*(sc.render_stereo(T)
                                                                    for sc in scenes))]
              for T in poses]
        sc = scenes[0]
        cam = StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width,
                                  height=sc.height)
        bvo = BatchedVisualOdometry(B, cam, FrontendConfig(n_points=512, n_lines=128,
                                                           fast_th=15.0), device=dev)
        bvo.initialize(*fr[0])
        bvo.process(*fr[1])
        before = [fn.launches for fn in wrappers]
        res = bvo.process(*fr[2])
        torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(wrappers, before)] == [4, 2, 4]
        assert res.T_f_w.shape == (B, 4, 4) and bool(res.good.all())


def test_default_device_takes_images_moved_to_cuda(dev):
    """``VisualOdometry`` and ``BatchedVisualOdometry`` at their default
    device ``"cuda"`` take images moved with ``.to("cuda")`` (they report
    ``cuda:0``)."""
    import numpy as np

    from plslam_tpu_torch.batch_vo import BatchedVisualOdometry
    from plslam_tpu_torch.core.camera import StereoCamera
    from plslam_tpu_torch.io.synthetic import SyntheticScene
    from plslam_tpu_torch.vo import VisualOdometry

    scene = SyntheticScene(n_points=300, n_lines=30, seed=1, width=376, height=240,
                           fx=217.6, fy=217.6, cx=183.7, cy=126.1)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    il, ir = (torch.from_numpy(x).to("cuda") for x in scene.render_stereo(np.eye(4)))
    feats = VisualOdometry(cam).initialize(il, ir)
    assert int(feats.points.valid.sum()) > 20
    bvo = BatchedVisualOdometry(1, cam)
    bvo.initialize(il[None], ir[None])
