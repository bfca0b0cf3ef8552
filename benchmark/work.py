"""Bytes and operations of the port's three hand-written kernels, from the
shapes of their inputs, and the published peaks they are held against.

The arithmetic is the benchmark's own copy of the kernel table's (inputs
read once, outputs written once, whatever a kernel reads again); nothing
here imports the port.  The peaks are NVIDIA's data sheet for the H100 SXM
at its 700 W limit: HBM3 bytes/s, float32 operations/s outside the tensor
cores (an FMA counts two), dense int8 tensor-core operations/s.  A float32
add issues at half the FMA-counted rate and min, max and compare at a
quarter (the CUDA C++ guide's throughput table for compute capability 9.0).
"""

from __future__ import annotations

PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "f32": 67e12, "int8": 1979e12}}

# FAST + NMS per pixel: the compass test (4 differences, 8 compares) and the
# 3x3 NMS (9 max, 2 compares): (adds, min/max/compare)
FAST_PX_OPS = (4, 8 + 11)

# the kernels' names in a device trace
KERNELS = {"fast_score_nms_batch": "fast_score_nms_kernel",
           "gather_patches_batch": "gather_patches_kernel",
           "hamming_distance_matrix_cuda": "hamming_mma_kernel"}


def peaks(kind: str) -> dict:
    """Operations/s by type and ``hbm`` bytes/s of the card ``kind``
    (``torch.cuda.get_device_name``); an unknown card raises."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}")
    p = PEAKS[kind]
    return {"hbm": p["hbm"], "f32_add": p["f32"] / 2, "f32_minmax": p["f32"] / 4,
            "int8": p["int8"]}


def fast(shape: tuple) -> tuple:
    """FAST + NMS over a (B, H, W) float32 stack with (B,) thresholds: the
    images read, raw and NMS maps written, the thresholds read; the
    per-pixel operations.  Pixels that pass the compass test pay more
    (the window folds), which depends on the data and is not counted, so
    the operation count is a floor."""
    b, h, w = shape
    px = b * h * w
    return 12 * px + 4 * b, {"f32_add": FAST_PX_OPS[0] * px, "f32_minmax": FAST_PX_OPS[1] * px}


def patches(img_shape: tuple, corner_shape: tuple, patch: int) -> tuple:
    """Patch gather: the float32 images and the int32 corner rows and
    columns read, the float32 patches written."""
    b, h, w = img_shape
    n = corner_shape[0] * corner_shape[1]
    return 4 * b * h * w + 2 * 4 * n + 4 * n * patch * patch, {}


def hamming(shape1: tuple, shape2: tuple) -> tuple:
    """Hamming matrix of ([B,] N1, 8) x ([B,] N2, 8) int32 words: the words
    read, the int32 matrix written; 2 one-bit operations per bit pair at the
    int8 rate."""
    b = shape1[0] if len(shape1) == 3 else 1
    n1, n2 = shape1[-2], shape2[-2]
    return b * ((n1 + n2) * 32 + n1 * n2 * 4), {"int8": 2.0 * b * n1 * n2 * 256}


def work(kernel: str, shapes: tuple) -> tuple:
    """(bytes, {operation type: count}) of one launch of ``kernel`` (a
    wrapper name of ``KERNELS``) on inputs of ``shapes``."""
    if kernel == "fast_score_nms_batch":
        return fast(shapes[0])
    if kernel == "gather_patches_batch":
        return patches(shapes[0], shapes[1], shapes[3])
    if kernel == "hamming_distance_matrix_cuda":
        return hamming(shapes[0], shapes[1])
    raise KeyError(f"no work formula for {kernel}")


def bound_s(nbytes: float, ops: dict, kind: str) -> float:
    """Least seconds the card could take: bytes over the memory rate or the
    operations over their rates, the larger."""
    p = peaks(kind)
    return max(nbytes / p["hbm"], sum(n / p[t] for t, n in ops.items()))
