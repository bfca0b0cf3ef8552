"""Synthetic scenes, trajectory evaluation, and the disk path's readers:
EuRoC / directory datasets, ground truth and the prefetching loader."""

from .euroc import (EurocDataset, RectifiedCalib, StereoDirDataset,  # noqa: F401
                    load_euroc_calib, load_groundtruth, sorted_images)
from .loader import StereoLoader  # noqa: F401
from .synthetic import SyntheticScene, circular_trajectory  # noqa: F401
from .trajectory import associate_timestamps, ate_rmse, save_tum  # noqa: F401
