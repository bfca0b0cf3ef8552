"""plslam_tpu_torch.config's builders against PLSLAMConfig's own builder
methods (which return the JAX package's types): the same field names and
values, for the defaults and for configs that the repo ships."""

import dataclasses
from pathlib import Path

import pytest

from plslam_tpu.config import PLSLAMConfig
from plslam_tpu_torch import config as C

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
# JAX-only fields: the Pallas kernel switches (the port picks a kernel or
# its plain version from the tensor's device)
JAX_ONLY = {"frontend": {"use_pallas_fast", "use_pallas_patches"}}


def _fields(obj) -> dict:
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj._asdict()


@pytest.mark.parametrize("source", [None, "config_euroc.yaml", "config_full.yaml"])
@pytest.mark.parametrize("builder", ["frontend", "tracker", "map_cfg", "loop_cfg", "ba"])
def test_builder_matches_jax(builder, source):
    cfg = PLSLAMConfig() if source is None else PLSLAMConfig.from_yaml(str(CONFIGS / source))
    want = _fields(getattr(cfg, builder)())
    got = _fields(getattr(C, builder)(cfg))
    assert set(want) - set(got) == JAX_ONLY.get(builder, set())
    assert got == {k: want[k] for k in got}


def test_frontend_image_size():
    cfg = PLSLAMConfig()
    got, want = _fields(C.frontend(cfg, 376)), _fields(cfg.frontend(376))
    assert got == {k: want[k] for k in got}
    assert got["stereo_window"] != _fields(C.frontend(cfg, 752))["stereo_window"]
