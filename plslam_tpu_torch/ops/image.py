"""Image filters on (B, H, W) stacks: Gaussian blur, Sobel, resize,
pyramid, and the bilinear remap of stereo rectification.

Blur and Sobel are separable ``conv2d`` with replicate padding; the JAX
package writes them as banded matmuls only to suit the TPU
(``plslam_tpu/ops/image.py:4-14``).  Resize keeps the numpy-built
resampling matrix of the JAX package as a product, because that matrix
is the definition of the resampling.  TF32 is off (``device.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_taps(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) antialiased-bilinear matrix, as built by
    ``plslam_tpu.ops.image._resize_matrix``."""
    s = n_out / n_in
    scale = min(s, 1.0)
    x_in = (np.arange(n_out) + 0.5) / s - 0.5
    t = (np.arange(n_in)[None, :] - x_in[:, None]) * scale
    M = np.maximum(0.0, 1.0 - np.abs(t))
    M /= M.sum(1, keepdims=True)
    return M.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _taps_tensor(taps: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(taps, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _resize_tensor(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(n_out, n_in)).to(device)


def _sep_filter(imgs: torch.Tensor, row_taps: tuple, col_taps: tuple) -> torch.Tensor:
    """out[y, x] = sum_ij row[i] col[j] img[clip(y+i-r), clip(x+j-r)]."""
    ky = _taps_tensor(tuple(float(np.float32(t)) for t in row_taps), imgs.device)
    kx = _taps_tensor(tuple(float(np.float32(t)) for t in col_taps), imgs.device)
    ry, rx = (len(row_taps) - 1) // 2, (len(col_taps) - 1) // 2
    x = imgs[:, None]
    x = F.conv2d(F.pad(x, (0, 0, ry, ry), mode="replicate"), ky.view(1, 1, -1, 1))
    x = F.conv2d(F.pad(x, (rx, rx, 0, 0), mode="replicate"), kx.view(1, 1, 1, -1))
    return x[:, 0]


def blur(imgs: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of a (B, H, W) stack, edge-replicated."""
    taps = tuple(_gaussian_taps(sigma))
    return _sep_filter(imgs, taps, taps)


_SOBEL_SMOOTH = (1.0, 2.0, 1.0)
_SOBEL_DIFF = (-1.0, 0.0, 1.0)


def sobel(imgs: torch.Tensor):
    """(gx, gy) Sobel gradients with replicate padding."""
    return (_sep_filter(imgs, _SOBEL_SMOOTH, _SOBEL_DIFF),
            _sep_filter(imgs, _SOBEL_DIFF, _SOBEL_SMOOTH))


def resize_bilinear(imgs: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize, out = RY @ img @ RX^T."""
    H, W = imgs.shape[-2:]
    h, w = shape
    if (h, w) == (H, W):
        return imgs
    RY = _resize_tensor(h, H, imgs.device)
    RX = _resize_tensor(w, W, imgs.device)
    return RY @ imgs @ RX.T


def build_pyramid(imgs: torch.Tensor, n_levels: int, scale_factor: float):
    """List of n_levels stacks; level i is resized by 1/scale_factor^i."""
    H, W = imgs.shape[-2:]
    levels = [imgs]
    for i in range(1, n_levels):
        s = scale_factor ** i
        levels.append(resize_bilinear(imgs, (int(round(H / s)), int(round(W / s)))))
    return levels


def bilinear_sample(imgs: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample each (H, W) image of a (B, H, W) stack at its (B, ..., 2)
    float (x, y) pixel coordinates, borders clamped
    (``plslam_tpu.ops.image.bilinear_sample``, one image per batch item)."""
    B, H, W = imgs.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.000001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = imgs.reshape(B, H * W)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * W + xi).reshape(B, -1)).reshape(yi.shape)

    return ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x1))
            + fy * ((1 - fx) * at(y1, x0) + fx * at(y1, x1)))


def remap(imgs: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """cv2.remap with float maps and clamped borders on a stack:
    out[b, i, j] = bilinear(imgs[b], map_x[b, i, j], map_y[b, i, j])
    (``plslam_tpu.ops.image.remap``; rectifyImagesLR,
    pinholeStereoCamera.cpp:200)."""
    return bilinear_sample(imgs, torch.stack([map_x, map_y], dim=-1))
