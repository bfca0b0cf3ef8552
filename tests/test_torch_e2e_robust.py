"""``plslam_tpu_torch.e2e_robust`` against ``scripts/e2e_robust.py``.

The nuisance frames (gain, bias, occluders, noise 2.0), rendered by the
port in worker processes or in this one, equal the script's serial
render with the JAX package's scene, bit for bit.  Both line modes of each
package's PLSLAM then run over the same frames at 376x240 (the script's
scene and deep-world redraw at that size, its trajectory, 8 frames).

Held per mode: keyframe and good-frame counts within 1 of JAX's, and the
aligned keyframe ATE under max(2x the JAX package's, 0.01 m), the smoke
runs' floor (the ATE is chaotic in the detected features).  Keyframe
counts are not held equal: in Plücker mode frame 7's entropy ratio sits on
the 0.85 keyframe threshold (port 0.8500, JAX 0.8499 on this CPU; the
ratios differ by ~5e-4 frame by frame, from the detected features), so JAX
takes a keyframe there and the port does not (2 against 3 keyframes; at 12
frames 3 against 4).  Endpoint mode: 2 keyframes each, ATE 0.0010 m
against 0.0012 m.  The
full-width case (752x480, 48 frames: chip_smoke phase 12's size) is
``slow`` and holds phase 12's floor: the ATE under max(2x the largest JAX
CPU value over six nuisance draws at N = 48, 0.01 m)
(``scripts/e2e_mode_divergence.py run jax MODE 48 [--noise-seed 1-5]``).
The ATE is chaotic in the draw on both sides: JAX's endpoint ATE over the
draws is 0.0062-0.0233 m and the port's 0.0059-0.0333 m, each package the
lower on some draws (Plücker: 0.0040-0.0220 and 0.0062-0.0274 m)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu_torch import e2e_robust as E
from plslam_tpu_torch.core.camera import StereoCamera
from test_torch_helpers import load_script, one_torch_thread  # noqa: F401

SMALL = dict(width=376, height=240, fx=217.6, fy=217.6, cx=183.7, cy=126.1)
N = 8
# scripts/e2e_mode_divergence.py run jax MODE 48 on a CPU (x86-64): (good
# frames and keyframes of the default draw, the largest unrounded keyframe
# ATE over it and the draws of --noise-seed 1-5) per mode
JAX_48 = {"plucker": (47, 12, 0.022040719599415688), "endpoint": (47, 12, 0.023334326469678014)}


def _jax_scene(J, size):
    scene = J.SyntheticScene(n_points=1600, n_lines=160, seed=3, **size)
    rng = np.random.default_rng(9)
    scene.P[:, 2] = rng.uniform(2.0, 30.0, len(scene.P))
    scene.LA[:, 2] = rng.uniform(2.0, 28.0, len(scene.LA))
    scene.LB[:, 2] = scene.LA[:, 2] + rng.uniform(-1.0, 1.0, len(scene.LB))
    return scene


def _serial(J, size, poses):
    """The script's own render loop (its main) on the JAX package's scene."""
    scene = _jax_scene(J, size)
    out = []
    for i, T in enumerate(poses):
        gain = 1.0 + 0.25 * np.sin(2 * np.pi * i / 150.0)
        bias = 8.0 * np.sin(2 * np.pi * i / 220.0)
        nocc = 2 if i % 3 == 0 else 0
        out.append(scene.render_stereo(T, noise=2.0, gain=gain, bias=bias, n_occluders=nocc))
    return out


@pytest.fixture(scope="module")
def J():
    return load_script("e2e_robust", ["8"])


@pytest.mark.parametrize("workers", [0, 2])
def test_frames_equal_the_serial_render(J, workers):
    poses = E.circular_trajectory(4, step_t=0.02, step_r=0.002)
    got = E.render_frames(E.make_scene(SMALL), poses, workers)
    want = _serial(J, SMALL, poses)
    for i, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


@pytest.fixture(scope="module")
def sequence():
    poses = E.circular_trajectory(N, step_t=0.02, step_r=0.002)
    return poses, E.render_frames(E.make_scene(SMALL), poses)


@pytest.mark.parametrize("plucker", [True, False], ids=["plucker", "endpoint"])
def test_mode_against_jax(J, sequence, plucker, tmp_path, monkeypatch):
    poses, frames = sequence
    sc = E.make_scene(SMALL)
    cam = StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width,
                              height=sc.height)
    jcam = J.StereoCamera.create(sc.fx, sc.fy, sc.cx, sc.cy, sc.b, width=sc.width,
                                 height=sc.height, dtype=jnp.float32)
    got = E.run_mode(plucker, frames, poses, cam, str(tmp_path), device="cpu")
    save_tum = J.save_tum
    monkeypatch.setattr(J, "save_tum", lambda p, *a: save_tum(
        str(tmp_path / ("jax_" + os.path.basename(p))), *a))
    want = J.run_mode(plucker, frames, poses, jcam)
    assert set(got) - {"ate_rmse_unrounded"} == set(want)
    assert abs(got["keyframes"] - want["keyframes"]) <= 1 and got["keyframes"] >= 2
    assert abs(got["good_frames"] - want["good_frames"]) <= 1
    assert got["ate_rmse_unrounded"] <= max(2.0 * want["ate_rmse_m"], 0.01), (got, want)
    mode = "plucker" if plucker else "endpoint"
    with open(tmp_path / f"e2e_robust_{mode}.tum") as f:
        assert len(f.read().splitlines()) == got["keyframes"]


def test_main_writes_the_dumps_and_prints_the_lines(tmp_path, capsys, monkeypatch):
    """main: one JSON line per mode, Plücker first, the TUM dumps and the
    ground truth under --out (the runs stubbed: the modes are held above;
    the frames rendered in this process)."""
    def fake(plucker, frames, poses, cam, out_dir, default_caps, device):
        mode = "plucker" if plucker else "endpoint"
        E.save_tum(os.path.join(out_dir, f"e2e_robust_{mode}.tum"), [0.0], [np.eye(4)])
        print(json.dumps({"mode": mode, "default_caps": default_caps}))
        return {"mode": mode}

    monkeypatch.setattr(E, "run_mode", fake)
    render = E.render_frames
    monkeypatch.setattr(E, "render_frames", lambda scene, poses, workers: render(scene, poses))
    out = E.main(["3", "--out", str(tmp_path), "--default-caps", "--device", "cpu"])
    assert [o["mode"] for o in out] == ["plucker", "endpoint"]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == [{"mode": "plucker", "default_caps": True},
                     {"mode": "endpoint", "default_caps": True}]
    assert sorted(os.listdir(tmp_path)) == ["e2e_robust_endpoint.tum", "e2e_robust_gt.tum",
                                            "e2e_robust_plucker.tum"]
    with open(tmp_path / "e2e_robust_gt.tum") as f:
        assert [ln.split()[0] for ln in f] == ["0.000000", "0.050000", "0.100000"]


@pytest.mark.slow
def test_full_width_48_frames(tmp_path):
    out = E.main(["48", "--out", str(tmp_path), "--device", "cpu"])
    for o in out:
        good, nkf, ate = JAX_48[o["mode"]]
        assert o["good_frames"] >= good - 0.05 * 48
        assert o["ate_rmse_unrounded"] <= max(2.0 * ate, 0.01), o
