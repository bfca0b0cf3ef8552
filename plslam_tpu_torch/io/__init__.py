"""Synthetic scenes and trajectory evaluation (numpy only)."""

from .synthetic import SyntheticScene, circular_trajectory  # noqa: F401
from .trajectory import ate_rmse, save_tum  # noqa: F401
