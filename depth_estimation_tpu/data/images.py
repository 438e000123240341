"""Image sources: file-sequence loader and conversions.

Rebuilds image_loader.lua (numbered ``images/%09d.jpg|png`` sequences,
/root/reference/image_loader.lua:7-43) plus the image helpers the reference
pulls from the torch 'image' package (load/scale/rgb2y). Decoding is PIL on
host. Resizing comes in three forms with identical kernels: ``scale``
(device, single image), ``scale_batched_device`` (device, separable
matmuls — the jitted-pipeline form), ``scale_np`` (host BLAS — the
frame-source/loader form, no device resize + fetch per frame). The webcam
source
(image_camera.lua) is ``ImageCamera``: real raw-ioctl V4L2 when a device
path is given (data/v4l2.py), programmatic queue otherwise.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

try:
    from PIL import Image as _PILImage
except ImportError:  # pragma: no cover
    _PILImage = None


def load_image(path: str) -> np.ndarray:
    """Load an image file -> (H, W, 3) float32 in [0, 1] (torch image.load
    convention, but channels-last)."""
    assert _PILImage is not None, "PIL unavailable"
    im = _PILImage.open(path).convert("RGB")
    return np.asarray(im, np.float32) / 255.0


def scale(img: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Bilinear resize to (h, w) — torch image.scale equivalent."""
    img = jnp.asarray(img)
    return jax.image.resize(img, (h, w) + img.shape[2:], method="bilinear")


def _resize_operator(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix reproducing jax.image.resize's antialiased
    linear kernel along one axis (triangle kernel stretched by the
    downscale factor, edge-clamped, weights normalized)."""
    s = n_out / n_in
    x = (np.arange(n_out) + 0.5) / s - 0.5          # sample centers
    j = np.arange(n_in)
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) * min(s, 1.0))
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


_resize_op_cache: dict = {}


def scale_batched_device(frames: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """DEVICE-side batched bilinear resize (B, H, W, C) -> (B, h, w, C) as
    two separable triangle-kernel MATMULS — same resampling kernel as
    ``scale``/jax.image.resize (``_resize_operator``). Jit-safe (operators
    are baked as constants per (H, h, W, w))."""
    H, W = frames.shape[1:3]
    if (H, W) == (h, w):
        return frames
    key = (H, h, W, w)
    if key not in _resize_op_cache:
        _resize_op_cache[key] = (_resize_operator(H, h), _resize_operator(W, w))
    R, C = _resize_op_cache[key]
    t = jnp.einsum("hH,bHWc->bhWc", jnp.asarray(R), frames)
    return jnp.einsum("wW,bhWc->bhwc", jnp.asarray(C), t)


def scale_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """HOST-side bilinear resize matching ``scale`` (separable matmuls with
    cached operators). Used by streaming drivers to downscale camera frames
    BEFORE the host->device upload — a 640x480 uint8 frame is 6x the
    bytes of its 320x180 working-resolution version.
    uint8 in -> uint8 out (f32 passes through as f32)."""
    H, W = img.shape[:2]
    key = (H, h, W, w)
    if key not in _resize_op_cache:
        _resize_op_cache[key] = (_resize_operator(H, h), _resize_operator(W, w))
    R, C = _resize_op_cache[key]
    was_u8 = img.dtype == np.uint8
    x = img.astype(np.float32)
    if x.ndim == 2:
        x = x[..., None]
    flat = x.reshape(H, -1)                          # (H, W*C)
    x = (R @ flat).reshape(h, W, -1)                 # rows resized (BLAS)
    # columns: (h, W, C) -> (h*C, W) @ C.T via a transpose round trip
    # (np.einsum has no BLAS path for this contraction — 300 ms vs 3 ms)
    xt = np.ascontiguousarray(x.transpose(0, 2, 1)).reshape(-1, W)
    x = (xt @ C.T).reshape(h, -1, w).transpose(0, 2, 1)
    if was_u8:
        return np.clip(x + 0.5, 0, 255).astype(np.uint8)
    return x if img.ndim == 3 else x[..., 0]


def rgb2y(img: jnp.ndarray) -> jnp.ndarray:
    """Luma conversion (torch image.rgb2y weights). (H, W, 3) -> (H, W, 1)."""
    w = jnp.asarray([0.299, 0.587, 0.114], img.dtype)
    return (img[..., :3] * w).sum(-1, keepdims=True)


class ImageLoader:
    """Sequential frame source over numbered files
    (/root/reference/image_loader.lua:7-43)."""

    def __init__(self, directory: str, h: int, w: int,
                 first: int = 0, pattern: str = "%09d"):
        self.dir = directory
        self.h, self.w = h, w
        self.i = first
        self.pattern = pattern

    def _path(self, i: int) -> Optional[str]:
        for ext in (".jpg", ".png"):
            p = os.path.join(self.dir, "images", (self.pattern % i) + ext)
            if os.path.exists(p):
                return p
        return None

    def get_next_frame(self) -> Optional[np.ndarray]:
        p = self._path(self.i)
        if p is None:
            return None
        self.i += 1
        img = load_image(p)
        if img.shape[:2] != (self.h, self.w):
            img = scale_np(img, self.h, self.w)   # host-side resize
        return img


class ImageCamera:
    """Live camera source (/root/reference/image_camera.lua:10-27): V4L
    capture at 640x480, NTSC, drop-one-frame latency flush, then a vertical
    center crop to the target aspect ratio.

    Pass ``device`` (e.g. "/dev/video0") for real V4L2 capture (raw-ioctl
    backend, data/v4l2.py); without a device, frames can be provided
    programmatically via ``push`` (the fake backend used in tests and the
    simulator loop)."""

    def __init__(self, h: int, w: int, device: Optional[str] = None,
                 capture_w: int = 640, capture_h: int = 480):
        self.h, self.w = h, w
        self._queue: list = []
        self._cam = None
        if device is not None:
            from .v4l2 import V4L2Camera
            self._cam = V4L2Camera(device, capture_w, capture_h)

    def push(self, frame: np.ndarray) -> None:
        self._queue.append(frame)

    def _center_crop_aspect(self, frame: np.ndarray) -> np.ndarray:
        """Crop rows so frame matches the target aspect (the reference's
        narrow(2, diff_h/2, target_h), image_camera.lua:22-24)."""
        fh, fw = frame.shape[:2]
        target_h = int(round(self.h * fw / self.w))
        if target_h < fh:
            top = (fh - target_h) // 2
            frame = frame[top:top + target_h]
        return frame

    def get_next_frame(self) -> Optional[np.ndarray]:
        if self._cam is not None:
            self._cam.read()            # drop one buffered frame (:20-21)
            img = self._center_crop_aspect(self._cam.read())
        else:
            if not self._queue:
                return None
            img = self._center_crop_aspect(self._queue.pop(0))
        if img.shape[:2] != (self.h, self.w):
            img = scale_np(img, self.h, self.w)   # host-side resize
        return img

    def close(self) -> None:
        if self._cam is not None:
            self._cam.close()
            self._cam = None
