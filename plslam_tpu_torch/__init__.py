"""PyTorch/CUDA port of ``plslam_tpu``: the stereo VO main path
(``vo.py``), the full SLAM path (``pipeline.PLSLAM``: tracking, mapping
worker thread, local BA, chunked global BA, loop closure), the disk entry
point (``run_euroc``), batched multi-stream VO (``batch_vo``) and the
RGB-D front end (``frontend/rgbd.py``).

Same layout and module names as the JAX package (``core/``, ``ops/``,
``frontend/``, ``backend/``, ``vo.py``, ``pipeline.py``, ``config.py``).
The three Pallas TPU kernels are hand-written CUDA kernels under
``csrc/``, bound through
``ops/cuda_patches.py``, ``ops/cuda_fast.py`` and ``ops/cuda_hamming.py``.
"""

from . import device  # noqa: F401  (applies the precision policy)
