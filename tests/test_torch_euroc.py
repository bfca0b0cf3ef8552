"""The port's disk path readers against the JAX package's: calibration and
rectification maps of every shipped params file, the EuRoC and directory
datasets (file order, decimation, timestamps, pixels), the ground-truth
parsers, ``associate_timestamps``, the mini fixture against
``scripts/make_mini_euroc.make`` (text files byte-identical, pixels equal),
``remap`` / ``bilinear_sample`` against JAX to 1e-4, the host rectification
against cv2.remap to 2 grey levels, and the prefetching loader against the
dataset (one get per frame, errors raised, a threaded stress run).  Frames
decode with cv2.imread, as in JAX; a frame that cannot be read raises."""

import filecmp
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.io import euroc as jeuroc
from plslam_tpu.io import trajectory as jtraj
from plslam_tpu.ops import image as jimage
from plslam_tpu_torch.io import euroc, mini_euroc
from plslam_tpu_torch.io.loader import StereoLoader
from plslam_tpu_torch.io.trajectory import associate_timestamps
from plslam_tpu_torch.ops import image

cv2 = pytest.importorskip("cv2")

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFIGS = os.path.join(ROOT, "configs")
PARAMS = ["asusxtion_params.yaml", "dataset_params.yaml", "euroc_params.yaml",
          "kitti00-02.yaml", "kitti03.yaml", "kitti04-10.yaml", "perceptin_params.yaml"]
TEXT_FILES = ["mav0/cam0/data.csv", "params.yaml", "groundtruth.csv", "gt-ass/groundtruth.txt",
              "gt-ass/associations.txt", "groundtruth_tum.txt"]


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The port's and the script's 8-frame mini fixtures."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import make_mini_euroc

    base = tmp_path_factory.mktemp("mini")
    return (mini_euroc.make(str(base / "port"), frames=8),
            make_mini_euroc.make(str(base / "script"), frames=8))


@pytest.fixture(scope="module")
def euroc_pairs(tmp_path_factory):
    """Three smooth-textured 752x480 pairs on disk (EuRoC's raw size) and
    the rectification of configs/euroc_params.yaml."""
    d = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:480, 0:752].astype(np.float64)
    for side in ("cam0", "cam1"):
        os.makedirs(d / side / "data")
    for i in range(3):
        for side in ("cam0", "cam1"):
            f = rng.uniform(0.01, 0.08, 4)
            img = 127 + 60 * np.sin(f[0] * xx + f[1] * yy) + 60 * np.cos(f[2] * xx - f[3] * yy)
            img += rng.normal(0, 3, img.shape)
            assert cv2.imwrite(str(d / side / "data" / f"{1403636580000000000 + i}.png"),
                               np.clip(img, 0, 255).astype(np.uint8))
    return str(d), os.path.join(CONFIGS, "euroc_params.yaml")


@pytest.mark.parametrize("name", PARAMS)
def test_calib_matches_jax(name):
    path = os.path.join(CONFIGS, name)
    got, want = euroc.load_euroc_calib(path), jeuroc.load_euroc_calib(path)
    for f in ("fx", "fy", "cx", "cy", "baseline", "width", "height", "identity_maps"):
        assert getattr(got, f) == getattr(want, f), f
    for a, b in zip(got.map_l + got.map_r, want.map_l + want.map_r, strict=True):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dec", [dict(), dict(offset=2, nmax=3), dict(offset=1, step=3),
                                 dict(nmax=2, step=2)])
def test_euroc_dataset_matches_jax(fixtures, dec):
    info = fixtures[0]
    calib = euroc.load_euroc_calib(info["params"])
    got = euroc.EurocDataset(info["dir"], calib, **dec)
    want = jeuroc.EurocDataset(info["dir"], jeuroc.load_euroc_calib(info["params"]), **dec)
    assert got.files_l == want.files_l and got.files_r == want.files_r
    assert got.timestamps == want.timestamps and len(got) == len(want) > 0
    for i in range(len(got)):
        for a, b in zip(got[i], want[i], strict=True):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("ext", ["png", "pgm"])
def test_stereo_dir_dataset_counter_names(tmp_path, ext):
    """KITTI-style 000000.png names: numeric order, 10 Hz timestamps; every
    format of sorted_images decodes through cv2, as in JAX."""
    rng = np.random.default_rng(1)
    for sub in ("image_2", "image_3"):
        os.makedirs(tmp_path / sub)
        for i in (0, 2, 10, 1):
            img = rng.integers(0, 256, (9, 13), dtype=np.uint8)
            path = str(tmp_path / sub / f"{i:06d}.{ext}")
            assert cv2.imwrite(path, img)
    calib = euroc.load_euroc_calib(os.path.join(CONFIGS, "kitti00-02.yaml"))
    got = euroc.StereoDirDataset(str(tmp_path), calib, "image_2", "image_3", step=2)
    want = jeuroc.StereoDirDataset(str(tmp_path), jeuroc.load_euroc_calib(
        os.path.join(CONFIGS, "kitti00-02.yaml")), "image_2", "image_3", step=2)
    assert got.files_l == want.files_l and got.timestamps == want.timestamps == [0.0, 0.1]
    np.testing.assert_array_equal(got[1][0], want[1][0])


def test_euroc_dataset_needs_cam0(tmp_path):
    calib = euroc.load_euroc_calib(os.path.join(CONFIGS, "kitti00-02.yaml"))
    with pytest.raises(FileNotFoundError):
        euroc.EurocDataset(str(tmp_path), calib)


def test_host_rectification(euroc_pairs):
    """The port rectifies with the plain float remap and clamped borders,
    the JAX package's host path with cv2.remap (5-bit fixed-point weights,
    rounded to uint8, a constant black border): within a grey level where
    the map stays inside the image, and everywhere against cv2.remap with a
    replicated border; the plain remap equals JAX's ops.image.remap (the
    device path) to 1e-4."""
    d, params = euroc_pairs
    calib = euroc.load_euroc_calib(params)
    got = euroc.StereoDirDataset(d, calib, "cam0/data", "cam1/data")
    want = jeuroc.StereoDirDataset(d, jeuroc.load_euroc_calib(params), "cam0/data", "cam1/data")
    H, W = calib.height, calib.width
    for i in range(len(got)):
        for side, maps, files in ((0, calib.map_l, got.files_l), (1, calib.map_r, got.files_r)):
            g, w = got[i][side], want[i][side]
            mx, my = maps
            inside = (mx >= 0) & (mx <= W - 1) & (my >= 0) & (my <= H - 1)
            assert inside.mean() > 0.99 and np.abs(g - w)[inside].max() <= 1.0
            raw = euroc.read_image(files[i])
            rep = cv2.remap(raw, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)
            assert np.abs(g - rep).max() <= 1.0
            jl = jimage.remap(jnp.asarray(raw.astype(np.float32)), jnp.asarray(mx),
                              jnp.asarray(my))
            np.testing.assert_allclose(g, np.asarray(jl), rtol=0, atol=1e-4)
    # unrectified on request (the loader rectifies on the device)
    raw = euroc.StereoDirDataset(d, calib, "cam0/data", "cam1/data", rectify_on_host=False)
    np.testing.assert_array_equal(raw[0][0], euroc.read_image(got.files_l[0]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remap_and_bilinear_sample_match_jax(seed):
    rng = np.random.default_rng(seed)
    H, W, h, w = 23, 31, 17, 29
    imgs = rng.uniform(0, 255, (2, H, W)).astype(np.float32)
    # maps reach past every edge, and hit integer and edge coordinates
    mx = rng.uniform(-3, W + 3, (2, h, w)).astype(np.float32)
    my = rng.uniform(-3, H + 3, (2, h, w)).astype(np.float32)
    mx[:, 0, :5] = [0, W - 1, W - 1.000001, 5, 30.5]
    my[:, 0, :5] = [0, H - 1, 7, H - 1.000001, 0.25]
    got = image.remap(torch.from_numpy(imgs), torch.from_numpy(mx), torch.from_numpy(my))
    xy = rng.uniform(-2, 40, (2, 5, 3, 2)).astype(np.float32)
    got_s = image.bilinear_sample(torch.from_numpy(imgs), torch.from_numpy(xy))
    assert got.shape == (2, h, w) and got_s.shape == (2, 5, 3)
    for b in range(2):
        want = jimage.remap(jnp.asarray(imgs[b]), jnp.asarray(mx[b]), jnp.asarray(my[b]))
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=0, atol=1e-4)
        want_s = jimage.bilinear_sample(jnp.asarray(imgs[b]), jnp.asarray(xy[b]))
        np.testing.assert_allclose(got_s[b].numpy(), np.asarray(want_s), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["gt_csv", "gt_ass"])
def test_groundtruth_matches_jax(fixtures, kind):
    info = fixtures[0]
    (t1, p1), (t2, p2) = euroc.load_groundtruth(info[kind]), jeuroc.load_groundtruth(info[kind])
    np.testing.assert_array_equal(p1, p2)
    assert (t1 is None) == (t2 is None) == (kind == "gt_ass")
    if t1 is not None:
        np.testing.assert_array_equal(t1, t2)
    np.testing.assert_allclose(p1, np.stack([T[:3, 3] for T in info["poses"]]), atol=1e-6)


def test_groundtruth_rejects_unknown_format(tmp_path):
    (tmp_path / "gt.txt").write_text("1 2 3\n4 5 6\n")
    with pytest.raises(ValueError):
        euroc.load_groundtruth(str(tmp_path / "gt.txt"))


@pytest.mark.parametrize("max_dt", [0.02, 0.004])
def test_associate_timestamps_matches_jax(max_dt):
    rng = np.random.default_rng(7)
    t_gt = np.cumsum(rng.uniform(0.004, 0.006, 400)) + 1403636580.0
    t_est = np.sort(rng.choice(t_gt, 60, replace=False) + rng.normal(0, 0.004, 60))
    t_est = np.concatenate([[t_gt[0] - 1.0], t_est, [t_gt[-1] + 1.0]])
    got, want = associate_timestamps(t_est, t_gt, max_dt), jtraj.associate_timestamps(
        t_est, t_gt, max_dt)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    assert 0 < len(got[0]) < len(t_est)


def test_mini_fixture_matches_script(fixtures):
    port, script = fixtures
    for rel in TEXT_FILES:
        assert filecmp.cmp(os.path.join(port["dir"], rel), os.path.join(script["dir"], rel),
                           shallow=False), rel
    for cam in ("cam0", "cam1"):
        names = sorted(os.listdir(os.path.join(script["dir"], "mav0", cam, "data")))
        assert names == sorted(os.listdir(os.path.join(port["dir"], "mav0", cam, "data")))
        for n in names:
            want_path = os.path.join(script["dir"], "mav0", cam, "data", n)
            got_path = os.path.join(port["dir"], "mav0", cam, "data", n)
            # both write with cv2.imwrite: the same bytes, the same pixels
            assert filecmp.cmp(got_path, want_path, shallow=False), n
            np.testing.assert_array_equal(euroc.read_image(got_path),
                                          cv2.imread(want_path, cv2.IMREAD_GRAYSCALE))
    for a, b in zip(port["poses"], script["poses"], strict=True):
        np.testing.assert_array_equal(a, b)


def _dataset(info):
    return euroc.EurocDataset(info["dir"], euroc.load_euroc_calib(info["params"]))


def test_loader_matches_dataset(fixtures):
    ds = _dataset(fixtures[0])
    c = ds.calib
    with StereoLoader(ds.files_l, ds.files_r, c.width, c.height, maps=(c.map_l, c.map_r),
                      n_threads=3, queue_cap=2, device="cpu") as nl:
        assert len(nl) == len(ds)
        for i in range(len(ds)):
            pair = nl.fetch(i)
            assert pair.dtype == torch.uint8 and pair.shape == (2, c.height, c.width)
            il, ir = nl.rectify(pair)
            assert il.dtype == torch.float32
            np.testing.assert_array_equal(il.numpy(), ds[i][0])
            np.testing.assert_array_equal(ir.numpy(), ds[i][1])
        assert nl.n_decoded == len(ds) and nl.decode_s > 0


def test_loader_rectifies_like_the_host(euroc_pairs):
    d, params = euroc_pairs
    calib = euroc.load_euroc_calib(params)
    ds = euroc.StereoDirDataset(d, calib, "cam0/data", "cam1/data")
    with StereoLoader(ds.files_l, ds.files_r, calib.width, calib.height,
                      maps=(calib.map_l, calib.map_r), device="cpu") as nl:
        for i in range(len(ds)):
            il, ir = nl.get(i)
            np.testing.assert_array_equal(il.numpy(), ds[i][0])
            np.testing.assert_array_equal(ir.numpy(), ds[i][1])


def test_loader_hands_each_frame_over_once(fixtures):
    ds = _dataset(fixtures[0])
    with StereoLoader(ds.files_l, ds.files_r, ds.calib.width, ds.calib.height,
                      queue_cap=1, device="cpu") as nl:
        nl.get(0)
        with pytest.raises(ValueError, match="already taken"):
            nl.get(0)
        il, _ = nl.get(3)                    # frames 1 and 2 are dropped
        np.testing.assert_array_equal(il.numpy(), ds[3][0])
        with pytest.raises(ValueError):
            nl.get(2)
        with pytest.raises(IndexError):
            nl.get(len(ds))
        np.testing.assert_array_equal(nl.get(len(ds) - 1)[1].numpy(), ds[len(ds) - 1][1])


@pytest.mark.parametrize("fault", ["corrupt", "missing", "size"])
def test_loader_errors_raise_in_get(fixtures, tmp_path, fault):
    ds = _dataset(fixtures[0])
    files_l = list(ds.files_l)
    bad = str(tmp_path / "bad.png")
    if fault == "corrupt":
        with open(files_l[2], "rb") as f:
            data = f.read()
        with open(bad, "wb") as f:
            f.write(data[:len(data) // 2])
    elif fault == "size":
        assert cv2.imwrite(bad, np.zeros((4, 4), np.uint8))
    files_l[2] = bad
    err = {"corrupt": ValueError, "missing": FileNotFoundError, "size": ValueError}[fault]
    with StereoLoader(files_l, ds.files_r, ds.calib.width, ds.calib.height,
                      device="cpu") as nl:
        nl.get(0)
        nl.get(1)
        with pytest.raises(err):
            nl.get(2)
        np.testing.assert_array_equal(nl.get(3)[0].numpy(), ds[3][0])


def test_loader_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        StereoLoader([], [], 8, 8)


def test_loader_threads_stress(fixtures):
    """More decoding threads than cores, a one-frame window and a tiny
    switch interval: every frame arrives once, intact, in order, and every
    thread exits."""
    ds = _dataset(fixtures[0])
    files_l, files_r = ds.files_l * 4, ds.files_r * 4
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        nl = StereoLoader(files_l, files_r, ds.calib.width, ds.calib.height,
                          n_threads=2 * (os.cpu_count() or 4), queue_cap=1, device="cpu")
        got = [nl.fetch(i) for i in range(len(files_l))]
        nl.close()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in nl._threads)
    assert nl.n_decoded == len(files_l)
    for i, pair in enumerate(got):
        np.testing.assert_array_equal(pair[0].numpy(), ds[i % len(ds)][0])
