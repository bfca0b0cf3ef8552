"""Prefetching stereo loader: frames decode on host threads and are
rectified on the device (the counterpart of ``plslam_tpu/native/loader.py``
and its C++ ``Loader``, ``plslam_tpu/native/dataloader.cpp``).

Worker threads decode the PNG pairs ahead of the consumer, at most
``queue_cap`` frames ahead, with ``io/euroc.read_image`` (cv2.imread
releases the interpreter lock, so the threads decode in parallel).
``get(i)`` hands frame i over once, as the native loader's ``get``
consumes its frame: the consumer moves forward, a frame it skips is
dropped, and asking again for a frame at or before one already taken
raises instead of waiting forever.

The decoded pair travels to the device as one (2, H, W) uint8 stack, a
quarter of the bytes of float32, and the rectification maps go to the
device once; each pair is converted and remapped there
(``ops/image.remap``, clamped borders as the native ``remap_bilinear``).
The upload is a synchronous copy from the decoded array, which no thread
reuses, so no pinned buffer can be refilled under an unfinished copy;
``PLSLAM.process`` fetches its per-frame scalars and so waits for the
stream every frame anyway, and a non-blocking copy would save no host time.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..ops.image import remap
from .euroc import read_image


class StereoLoader:
    """Threaded prefetching loader over two sorted image file lists, with
    optional rectification maps ``((map_lx, map_ly), (map_rx, map_ry))``
    (float32 H x W each), on ``device`` (the card unless the caller asks for
    the CPU; no fallback)."""

    def __init__(self, files_l, files_r, width, height, maps=None, n_threads=4,
                 queue_cap=8, *, device="cuda"):
        if len(files_l) != len(files_r):
            raise ValueError(f"{len(files_l)} left and {len(files_r)} right files")
        if n_threads < 1 or queue_cap < 1:
            raise ValueError(f"n_threads {n_threads} and queue_cap {queue_cap} must be >= 1")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StereoLoader: device 'cuda' requested but CUDA is not available")
        self.files_l, self.files_r = list(files_l), list(files_r)
        self.width, self.height = int(width), int(height)
        self.n = len(self.files_l)
        self.queue_cap = queue_cap
        self._maps = None
        if maps is not None:
            (mlx, mly), (mrx, mry) = maps
            self._maps = tuple(torch.from_numpy(np.stack([a, b]).astype(np.float32)).to(self.device)
                               for a, b in ((mlx, mrx), (mly, mry)))
        self._cond = threading.Condition()
        self._next = 0          # next index a worker decodes
        self._taken = -1        # last index asked for; those below are dropped
        self._done: dict[int, np.ndarray | BaseException] = {}
        self._closed = False
        self.decode_s = 0.0     # worker seconds spent decoding pairs
        self.n_decoded = 0
        self._threads = [threading.Thread(target=self._work, name=f"plslam-loader-{k}",
                                          daemon=True) for k in range(n_threads)]
        for t in self._threads:
            t.start()

    def __len__(self):
        return self.n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- workers -----------------------------------------------------------

    def _decode(self, i: int) -> np.ndarray:
        pair = np.stack([read_image(self.files_l[i]), read_image(self.files_r[i])])
        if pair.shape != (2, self.height, self.width):
            raise ValueError(f"frame {i}: images of {pair.shape[1:]}, expected "
                             f"{(self.height, self.width)}")
        return pair

    def _work(self):
        while True:
            with self._cond:
                while (not self._closed and self._next < self.n
                       and self._next > self._taken + self.queue_cap):
                    self._cond.wait()
                if self._closed or self._next >= self.n:
                    return
                i = self._next
                self._next += 1
            t0 = time.perf_counter()
            try:
                out = self._decode(i)
            except Exception as e:  # handed to the consumer by get(i)
                out = e
            dt = time.perf_counter() - t0
            with self._cond:
                if i >= self._taken:
                    self._done[i] = out
                self.decode_s += dt
                self.n_decoded += 1
                self._cond.notify_all()

    # -- consumer ----------------------------------------------------------

    def take(self, index: int) -> np.ndarray:
        """Wait for frame ``index``, decoded on the host as a (2, H, W) uint8
        array; drop the frames before it."""
        if not 0 <= index < self.n:
            raise IndexError(f"frame {index} of {self.n}")
        with self._cond:
            if self._closed:
                raise RuntimeError("StereoLoader is closed")
            if index <= self._taken:
                raise ValueError(f"frame {index} was already taken or skipped: get() "
                                 "hands each frame over once, in increasing order")
            self._taken = index
            self._next = max(self._next, index)
            for k in [k for k in self._done if k < index]:
                del self._done[k]
            self._cond.notify_all()
            while index not in self._done:
                if self._closed:
                    raise RuntimeError("StereoLoader was closed while waiting")
                self._cond.wait()
            out = self._done.pop(index)
        if isinstance(out, BaseException):
            raise out
        return out

    def upload(self, pair: np.ndarray) -> torch.Tensor:
        """A taken (2, H, W) uint8 pair on the device (a synchronous copy)."""
        return torch.from_numpy(pair).to(self.device)

    def fetch(self, index: int) -> torch.Tensor:
        """Frame ``index`` as a (2, H, W) uint8 stack on the device."""
        return self.upload(self.take(index))

    def rectify(self, pair: torch.Tensor):
        """(left, right) float32 images of a fetched (2, H, W) stack,
        remapped with the rectification maps when the loader has them."""
        imgs = pair.to(torch.float32)
        if self._maps is not None:
            imgs = remap(imgs, *self._maps)
        return imgs[0], imgs[1]

    def get(self, index: int):
        """(left, right) float32 device images of frame ``index``."""
        return self.rectify(self.fetch(index))

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join()
