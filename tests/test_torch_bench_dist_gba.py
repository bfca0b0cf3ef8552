"""plslam_tpu_torch.bench_dist_gba (the port of scripts/bench_dist_gba.py)
with ``--device cpu``, 8 gloo rank processes, against the JAX script itself
on the conftest's 8-device CPU mesh, both at N_KF = 16 (2048 points, 128
lines; the script takes N_KF from its command line).

- ``pre_err`` (the median point error before the GBA) equals the JAX
  script's to 1e-6 m: the two packages draw the same ring map;
- the chunk counts of the kf-block GBA (``chunks``, ``chunks_per_device``)
  are JAX's on the same mesh;
- ``pt_err`` of ``single``, ``mesh8`` and ``mesh2x4`` each within
  tests/test_dist_gba.py's bars of JAX's for the same form: under half the
  error before the GBA, and under 1.25x JAX's + 1e-4 m;
- the JSON line carries exactly the JAX script's keys, form names and
  entry keys (read from its source text)."""

import contextlib
import io
import json
import os

import pytest

from plslam_tpu_torch import bench_dist_gba

from test_torch_helpers import json_literals, load_script

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_KF = 16
FORMS = ("single", "mesh8", "mesh2x4")


@pytest.fixture(scope="module")
def port():
    return bench_dist_gba.run(N_KF, device="cpu", timeout=240)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX script's printed line at N_KF, and its ``pre_err`` unrounded
    (its own ``build`` and ``pt_err``)."""
    script = load_script("bench_dist_gba", argv=[str(N_KF)])
    mapper, (_, pt_true) = script.build()
    pre = script.pt_err(mapper, pt_true)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        script.main()
    return json.loads(out.getvalue().strip().splitlines()[-1]), pre


def test_pre_err_equals_jax(port, jax_run):
    line, pre = jax_run
    assert abs(port["pre_err"] - pre) <= 1e-6, (port["pre_err"], pre)
    assert port["line"]["pre_err"] == line["pre_err"]


def test_chunks_equal_jax(port, jax_run):
    line, _ = jax_run
    got = port["line"]
    assert got["mesh8"]["chunks"] == line["mesh8"]["chunks"]
    assert got["mesh8"]["chunks_per_device"] == line["mesh8"]["chunks_per_device"]
    assert got["mesh2x4"]["chunks"] == line["mesh2x4"]["chunks"]


@pytest.mark.parametrize("form", FORMS)
def test_pt_err_within_bars_of_jax(port, jax_run, form):
    line, pre = jax_run
    got = port["pt_err"][form]
    print(f"{form}: pt_err port {got:.6f} m, JAX {line[form]['pt_err']:.5f} m, before {pre:.6f}")
    assert got < 0.5 * port["pre_err"]
    assert got < 1.25 * line[form]["pt_err"] + 1e-4


def test_json_line_has_the_jax_scripts_keys(port):
    lits = json_literals(os.path.join(ROOT, "scripts", "bench_dist_gba.py"))
    entries = {lit["target"]: lit["keys"] for lit in lits if lit["target"]}
    top = next(lit["keys"] for lit in lits if "pre_err" in lit["keys"])
    line = port["line"]
    assert list(line)[:len(top) - 1] == [k for k in top if k is not None]
    assert list(line)[len(top) - 1:] == list(entries) == list(FORMS)
    for form in FORMS:
        assert list(line[form]) == entries[form], form
