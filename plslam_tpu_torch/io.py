"""Synthetic scenes and trajectory evaluation, reused from the JAX package.

``plslam_tpu.io.synthetic`` and ``plslam_tpu.io.trajectory`` are numpy
only and import no jax, so the port imports them instead of copying.
"""

from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory  # noqa: F401
from plslam_tpu.io.trajectory import ate_rmse  # noqa: F401
