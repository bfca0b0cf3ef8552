from . import lie, plucker, robust
from .camera import StereoCamera, euroc_default_camera

__all__ = ["lie", "plucker", "robust", "StereoCamera", "euroc_default_camera"]
