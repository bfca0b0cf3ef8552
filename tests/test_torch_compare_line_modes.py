"""``plslam_tpu_torch.compare_line_modes`` against
``scripts/compare_line_modes.py``: both line modes of each package's
PLSLAM over the same rendered frames (the script's scene, SyntheticScene
seed 5 at 376x240, and its trajectory, cut to 8 frames).

Held: equal keyframe counts in each mode, and each mode's aligned keyframe
ATE under max(2x the JAX package's, 0.01 m), the floor of the smoke runs
(the ATE is chaotic in the detected features; exactness is held module by
module elsewhere).  Reading on this CPU: endpoint 0.006841 m against JAX
0.006409 m, Plücker 0.008459 against 0.007945, 4 keyframes each."""

import jax.numpy as jnp
import pytest

from plslam_tpu_torch import compare_line_modes as C
from plslam_tpu_torch.core.camera import StereoCamera
from test_torch_helpers import load_script, one_torch_thread  # noqa: F401

J = load_script("compare_line_modes")
N = 8


@pytest.mark.parametrize("plucker", [False, True], ids=["endpoint", "plucker"])
def test_mode_against_jax(plucker):
    scene = C.SyntheticScene(seed=5)
    poses = C.circular_trajectory(N, step_t=0.10, step_r=0.012)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    jcam = J.StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                                 width=scene.width, height=scene.height, dtype=jnp.float32)
    ate, nkf = C.run_mode(plucker, scene, cam, poses, device="cpu")
    want_ate, want_nkf = J.run_mode(plucker, J.SyntheticScene(seed=5), jcam, poses)
    assert nkf == want_nkf >= 3
    assert ate <= max(2.0 * want_ate, 0.01), (ate, want_ate)


def test_main_prints_the_scripts_lines(capsys, monkeypatch):
    """The printout of both modes and the |difference|, in the script's
    format (the runs stubbed: the modes are held above)."""
    monkeypatch.setattr(C, "run_mode", lambda plucker, *a: (0.02 if plucker else 0.03, 7))
    out = C.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"endpoint : ATE RMSE 0.03000 m over {out['travel_m']:.2f} m travel (7 KFs)"
    assert lines[1] == f"plucker  : ATE RMSE 0.02000 m over {out['travel_m']:.2f} m travel (7 KFs)"
    assert lines[2].startswith("|difference| = 0.01000 m (")
    assert abs(out["travel_m"] - 2.9093604808284628) < 1e-12   # the JAX script's 30 frames
