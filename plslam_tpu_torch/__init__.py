"""PyTorch/CUDA port of the stereo VO main path of ``plslam_tpu``.

Same layout and module names as the JAX package (``core/``, ``ops/``,
``frontend/``, ``vo.py``).  The three Pallas TPU kernels of the path are
hand-written CUDA kernels under ``csrc/``, bound through
``ops/cuda_patches.py``, ``ops/cuda_fast.py`` and ``ops/cuda_hamming.py``.
"""

from . import device  # noqa: F401  (applies the precision policy)
